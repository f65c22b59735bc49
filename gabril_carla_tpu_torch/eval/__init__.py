"""Closed-loop evaluation: the rollout with its gaze-heat paths, the BC eval
agent and stats.json output (port of gabril_carla_tpu.eval)."""
