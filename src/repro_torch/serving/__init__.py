"""Serving engines of the port."""
