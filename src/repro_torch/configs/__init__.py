"""Counterpart of ``repro.configs``."""
