"""Sharded proving over a mesh of devices driven by one process (sharded.py)."""
