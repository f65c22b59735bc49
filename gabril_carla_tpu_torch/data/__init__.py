"""Vendored benchmark data, task splits and the BC dataset."""
