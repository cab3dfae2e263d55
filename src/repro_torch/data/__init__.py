"""Counterpart of ``repro.data``."""
