"""BC policy construction (port of gabril_carla_tpu.train.bc, policy part)."""
