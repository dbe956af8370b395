"""Model configurations served by the port."""
