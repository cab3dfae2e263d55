"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  Nothing happens
at import: the first CUDA launch of a kernel builds it (or :func:`build`
builds them all, one ``nvcc`` per source, in parallel).  Libraries land in
``build/kernels/`` at the repo root, named by a hash of the sources and
flags, so an edited source rebuilds and an unchanged one loads as is.

``LAUNCHES`` counts launches per kernel: a wrapper adds one each time it
launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# the sources ``build()`` compiles by default, one library each;
# csrc/grouped_mm.cu (the drop-free MoE's products, counted in
# ``kernels.grouped_mm.LAUNCHES``) builds on first use, so a run that
# never launches it does not compile it
SOURCES = ("fedprox_accum", "nova_aggregate", "robust_aggregate",
           "fedprox_update", "swa_decode_attention")
# the kernels as the wrappers launch them: nova_aggregate.cu serves both
# nova_aggregate (one plane) and nova_aggregate_stacked (a replica stack)
KERNELS = ("fedprox_accum", "nova_aggregate", "robust_aggregate",
           "nova_aggregate_stacked", "fedprox_update", "swa_decode_attention")

LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: building the kernels "
                           "needs nvcc (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    """Where the library of ``name`` lives, keyed on a hash of its source,
    the shared header(s) and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, Tuple[float, str]]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns, per name, the
    seconds its build took (0.0 when already built) and nvcc's output
    (``-Xptxas=-v``: registers, shared memory, spills).  Raises if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    result = {name: (0.0, "") for name in names}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        result[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return result


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of kernel library ``name`` (built on first
    use), with its argument types set; it returns a CUDA error code."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIBS[name] = lib
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(name: str, err: int) -> None:
    """Raise if a launch of kernel ``name`` returned a CUDA error."""
    if err != 0:
        msg = getattr(_LIBS[name], f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")
