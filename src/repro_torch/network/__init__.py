"""Counterpart of ``repro.network``."""
