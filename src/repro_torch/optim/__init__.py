"""Optimizers of the port: AdamW (``optim.adamw``), the port of
``repro.optim``."""
