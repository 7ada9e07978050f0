"""The plain float32 reference that decides ``correct`` (``model.py``)."""
