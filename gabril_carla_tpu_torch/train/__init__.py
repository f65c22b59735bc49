"""BC training: models, loss and train step, optimizer, device-resident
epochs, checkpoints and the Trainer (port of gabril_carla_tpu.train)."""
