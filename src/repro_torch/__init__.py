"""PyTorch/CUDA port of the CE-FL system (counterpart of ``repro``).

Imports torch and numpy only, never jax or ``repro``.
"""
