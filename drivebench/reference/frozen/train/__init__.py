"""Frozen copy (see drivebench/reference/frozen/__init__.py)."""
