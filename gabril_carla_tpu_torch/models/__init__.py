"""Policy and gaze-predictor networks (port of gabril_carla_tpu.models)."""
