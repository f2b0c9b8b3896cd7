"""Frozen copy of the port's host verifier path: numpy and CPU torch only."""
