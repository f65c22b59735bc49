"""Pseudo-gaze tooling: detector boxes -> gaze coordinate streams."""
