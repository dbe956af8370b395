"""Training loop substrate (``loop``): step builder with gradient
accumulation, checkpoint/restart, straggler watchdog, instruments."""
