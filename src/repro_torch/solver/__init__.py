"""Counterpart of ``repro.solver``."""
