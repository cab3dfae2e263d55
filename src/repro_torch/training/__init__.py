"""Counterpart of ``repro.training``: checkpoints (``checkpoint.py``)."""
