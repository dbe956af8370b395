"""The LM zoo's models: ten architectures' forward, prefill and decode."""
