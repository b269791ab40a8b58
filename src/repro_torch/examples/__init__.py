"""Runnable examples of the port, as modules:
``python -m repro_torch.examples.<name>``."""
