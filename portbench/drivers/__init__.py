"""The drivers, one a traffic ``kind``."""
