"""Core numerics: neurons, surrogates, coding, the SNN model, Q1.15 and
the analytic energy model.  Submodules are imported explicitly."""
