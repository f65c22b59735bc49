"""Training: BC and gaze-predictor models, losses and train steps, the
optimizer, device-resident epochs, checkpoints and the Trainer (port of
gabril_carla_tpu.train)."""
