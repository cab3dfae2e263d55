"""Counterpart of ``repro.kernels``."""
