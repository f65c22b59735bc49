"""Policy networks (port of gabril_carla_tpu.models)."""
