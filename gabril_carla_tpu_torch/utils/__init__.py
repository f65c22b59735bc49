"""Config surface (copy of gabril_carla_tpu.utils.config)."""
