"""Runtime analysis for the port (counterpart of ``repro.analysis``):
the NaN/Inf sanitizer that ``EngineOptions(sanitize=True)`` turns on.

The reference's AST linter, jaxpr auditor, compile monitor and PRNG
key-reuse detector check JAX programs (traces, retraces, ``jax.random``
keys) and have no counterpart here: the port traces nothing, and its
draws come from one ``torch.Generator`` a run.
"""
from repro_torch.analysis.sanitize import (  # noqa: F401
    SanitizerError, check_finite,
)

__all__ = ["SanitizerError", "check_finite"]
