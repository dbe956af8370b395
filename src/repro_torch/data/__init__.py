"""Datasets of the port (numpy-seeded, so they match the reference)."""
