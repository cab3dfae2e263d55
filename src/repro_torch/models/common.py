"""Shared NN building blocks of the model track (counterpart of
``repro.models.common``): explicit parameter dicts, weights drawn from an
explicit ``torch.Generator``, and the :class:`ShardCtx` of the
sequence-sharded decode."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """How the model expresses distribution.

    ``mesh``: the ``torch.distributed`` process group over the cache axes
    (None: single-device paths everywhere).  With ``seq_shard_decode``
    each member holds its contiguous slice of every attention cache's
    sequence axis, member k the k-th, and the decode attention combines
    the members' partial softmaxes
    (``attention.decode_attention_seq_sharded``).  The reference's batch
    and tensor-parallel axes belong to its TPU-pod layout rules, which
    are not ported (ROADMAP queue 1 item 6.4)."""
    mesh: Optional[object] = None          # a torch.distributed group
    seq_shard_decode: bool = False

    @property
    def on_mesh(self) -> bool:
        return self.mesh is not None

    @property
    def shards(self) -> int:
        return dist.get_world_size(self.mesh)

    @property
    def shard(self) -> int:
        """This rank's position in the group: its slice of the caches."""
        return dist.get_rank(self.mesh)


NO_SHARD = ShardCtx()


def dense_init(gen: torch.Generator, in_dim, out_shape, dtype, scale=None):
    """N(0, 1/in_dim) weights of shape ``(in_dim, *out_shape)``, drawn in
    float32 on ``gen``'s device and cast to ``dtype``."""
    scale = scale if scale is not None else 1.0 / np.sqrt(in_dim)
    w = torch.randn((in_dim,) + tuple(out_shape), generator=gen,
                    device=gen.device)
    return (w * float(scale)).to(dtype)


def embed_init(gen: torch.Generator, vocab, d, dtype):
    w = torch.randn((vocab, d), generator=gen, device=gen.device)
    return (w * 0.02).to(dtype)


def rms_norm(x, scale, eps=1e-5):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dt)


def rope_frequencies(head_dim: int, theta: float, positions: torch.Tensor):
    """positions: (...,) integer -> (..., head_dim//2) f32 angles."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freq = 1.0 / (theta ** exps)
    return positions[..., None].float() * freq


def apply_rope(x, angles):
    """Split-half rotary embedding in f32.  x: (..., S, H, D); angles:
    (S, D//2) or broadcastable."""
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[..., None, :]   # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def matmul_f32(a, b):
    """``a @ b`` with a float32 result, for operands of one dtype: f32 as
    they are; bf16 multiplied exactly and summed in f32, which is what the
    JAX package's ``preferred_element_type=float32`` gives.  On a CUDA
    tensor that is cuBLAS's bf16 product with an f32 output
    (``out_dtype``); the CPU has no such overload, so there the operands
    are widened to f32 first (the same exact products, summed in f32).
    a: (..., M, K), b: (..., K, N) with equal batch dims (at most one)."""
    if a.dtype == torch.float32 or not a.is_cuda:
        return torch.matmul(a.float(), b.float())
    if a.dim() == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.bmm(a, b, out_dtype=torch.float32)
