"""Counterpart of ``repro.scenario``."""
