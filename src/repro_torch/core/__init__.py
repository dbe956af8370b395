"""Core numerics: neurons, surrogates, coding, the SNN model, Q1.15, the
analytic energy model and the binarized CNN baseline (``bcnn``).
Submodules are imported explicitly."""
