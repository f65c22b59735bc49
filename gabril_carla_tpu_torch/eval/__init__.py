"""Closed-loop evaluation (port of gabril_carla_tpu.eval.rollout)."""
