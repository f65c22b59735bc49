"""Closed-loop driving environment (port of gabril_carla_tpu.env)."""
