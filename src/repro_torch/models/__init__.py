"""Counterpart of ``repro.models``."""
