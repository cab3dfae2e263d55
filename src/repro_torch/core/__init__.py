"""Counterpart of ``repro.core``."""
