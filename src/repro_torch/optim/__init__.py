"""Optimizers of the port (``optim.adamw``: AdamW on tensor dicts, and
``adamw_update_``, its in-place counterpart)."""
