"""Vendored benchmark data and task splits."""
