"""Counterpart of ``repro.kernels``: the flat parameter plane, the kernel
ops that dispatch by the tensor's device (``ops``), their plain versions
(``ref``) and the hand-written CUDA kernels (``csrc``, built on first
launch).  Importing it builds nothing.  ``swa_decode_attention`` is the
kernel's module (its wrapper is ``ops.swa_decode_attention``), as the
reference's name resolves once its module is imported."""
from repro_torch.kernels import ops, plane, ref  # noqa: F401
from repro_torch.kernels import swa_decode_attention  # noqa: F401
from repro_torch.kernels.plane import (  # noqa: F401
    FlatSpec, ParamPlane, as_plane, as_tree, spec_of,
)

__all__ = [
    "ops", "plane", "ref",
    "FlatSpec", "ParamPlane", "as_plane", "as_tree", "spec_of",
    "swa_decode_attention",
]
