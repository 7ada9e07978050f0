"""Optimizers of the port (``optim.adamw``: AdamW on tensor dicts)."""
