"""Command-line entry points: training (BC, gaze predictor), closed-loop
route evaluation and score aggregation. Each ``main(argv=None, device=...)``
takes the device as a keyword argument and runs on the card by default."""
