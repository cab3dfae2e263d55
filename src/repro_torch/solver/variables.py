"""Decision-variable dict for problem P: initialization (feasible point),
projection onto the per-node convex sets D_d (boxes / simplexes, eqs. 45-49,
54-62, 66-68), the ownership ops of the distributed solver, rounding of the
relaxed indicator variables, and the flat (P,)-vector representation the
solver iterates over (:class:`WSpec`, :class:`NetView`, :class:`Scaler`).
Counterpart of ``repro.solver.variables``.

Devices.  Every tensor a function here makes lands on the device of its
tensor inputs (``D_bar``, ``v``, the :class:`NetView`'s arrays), so the
solver runs wherever its inputs live.  Numpy inputs (the engine's
``Network``) give CPU tensors.
"""
from __future__ import annotations

import functools
import itertools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.network.costs import as_f32

# Canonical key order of the decision dict w (matches core.api.PLAN_KEYS).
W_KEYS = ("rho_nb", "rho_bs", "f_n", "z_s", "gamma", "m",
          "I_s", "I_nb", "I_bn", "R_bs", "delta_A", "delta_R")


def w_shapes(dims) -> Dict[str, tuple]:
    """Per-key shapes of w at network dims (N, B, S)."""
    N, B, S = dims
    return {
        "rho_nb": (N, B), "rho_bs": (B, S), "f_n": (N,), "z_s": (S,),
        "gamma": (N + S,), "m": (N + S,), "I_s": (S,), "I_nb": (N, B),
        "I_bn": (B, N), "R_bs": (B, S), "delta_A": (), "delta_R": (),
    }


class WSpec:
    """Flattening spec: w dict <-> one (P,) float32 vector, keyed only on
    the network dims."""

    def __init__(self, dims):
        self.dims = tuple(int(d) for d in dims)
        self.shapes = w_shapes(self.dims)
        self.sizes = {k: int(np.prod(s, dtype=np.int64))
                      for k, s in self.shapes.items()}
        self.offsets = {}
        off = 0
        for k in W_KEYS:
            self.offsets[k] = off
            off += self.sizes[k]
        self.total = off

    def flatten(self, w: Dict) -> torch.Tensor:
        return torch.cat([as_f32(w[k]).reshape(-1) for k in W_KEYS])

    def unflatten(self, flat) -> Dict:
        return {k: flat[self.offsets[k]:self.offsets[k] + self.sizes[k]]
                .reshape(self.shapes[k]) for k in W_KEYS}


def owner_index(dims) -> np.ndarray:
    """(P,) owner node id of every flat component (UEs 0..N-1, BSs N..N+B-1,
    DCs N+B..N+B+S-1); the co-owned delta_A / delta_R entries get -1."""
    N, B, S = dims
    ue = np.arange(N)
    bs = N + np.arange(B)
    dc = N + B + np.arange(S)
    parts = {
        "rho_nb": np.repeat(ue, B), "rho_bs": np.repeat(bs, S),
        "f_n": ue, "z_s": dc,
        "gamma": np.concatenate([ue, dc]), "m": np.concatenate([ue, dc]),
        "I_s": dc, "I_nb": np.repeat(ue, B), "I_bn": np.repeat(bs, N),
        "R_bs": np.repeat(bs, S),
        "delta_A": np.array([-1]), "delta_R": np.array([-1]),
    }
    return np.concatenate([parts[k] for k in W_KEYS])


def ownership_matrix(dims) -> np.ndarray:
    """(V, P) ownership-mask matrix (host-side, tests only): exactly-one-
    owner components are one-hot columns; the DC-co-owned delta entries
    carry weight 1/S on every DC row, so ``M @ candidates`` is the
    Algorithm-2 masked merge.  The solver never builds it: it runs the
    segment ops below over :func:`owner_index`."""
    N, B, S = dims
    Vn = N + B + S
    own = owner_index(dims)
    M = (own[None, :] == np.arange(Vn)[:, None]).astype(np.float32)
    dc_rows = np.zeros(Vn, np.float32)
    dc_rows[N + B:] = 1.0 / S
    M[:, own < 0] = dc_rows[:, None]
    return M


@functools.lru_cache(maxsize=16)
def _owner_tensors(dims, device):
    own = owner_index(dims)
    return (torch.as_tensor(own, device=device),
            torch.as_tensor(np.maximum(own, 0), device=device),
            torch.as_tensor((own >= 0).astype(np.float32), device=device))


def owner_tensors(dims, device):
    """(owner, segment, single) on ``device``: :func:`owner_index`, its ids
    with the co-owned entries sent to row 0, and the float32 mask of the
    single-owner entries.  Built once per (dims, device) and shared, never
    written: made inside a solver step, each would be a synchronous
    host-to-device copy, which a CUDA graph cannot capture."""
    return _owner_tensors(tuple(int(d) for d in dims), torch.device(device))


def ownership_merge(cands, dims):
    """Algorithm-2 masked merge of the (V, P) candidate stack without the
    (V, P) matrix: every single-owner component takes its owner's
    candidate row; the DC-co-owned delta entries take the mean over the
    DC rows."""
    N, B, S = dims
    own = owner_tensors(dims, cands.device)[0]
    gathered = cands[torch.clamp(own, min=0),
                     torch.arange(own.shape[0], device=cands.device)]
    dc_mean = torch.mean(cands[N + B:], dim=0)
    return torch.where(own >= 0, gathered, dc_mean)


def owner_mask(v, dims):
    """Row ``v`` of :func:`ownership_matrix` (``v`` a 0-dim tensor, so the
    mask can be built under ``torch.func.vmap`` over node ids)."""
    N, B, S = dims
    own = owner_tensors(dims, v.device)[0]
    co_owned = (own < 0) & (v >= N + B)
    one = torch.ones((), device=v.device)
    return torch.where(own == v, one,
                       torch.where(co_owned, one / S, torch.zeros_like(one)))


def node_sq_norms(d, dims):
    """Per-node squared norms ``sum_p (d * mask_v)_p^2`` for all V nodes,
    one ``index_add`` over the flat owner index.  The co-owned delta
    entries contribute ``(d/S)^2`` to every DC row."""
    N, B, S = dims
    _, seg, single = owner_tensors(dims, d.device)
    sq = torch.zeros(N + B + S, device=d.device).index_add(
        0, seg, single * d * d)
    delta_sq = torch.sum((1.0 - single) * d * d) / (S * S)
    is_dc = torch.arange(N + B + S, device=d.device) >= N + B
    return sq + torch.where(is_dc, delta_sq, torch.zeros_like(delta_sq))


def _device_of(D_bar, device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if isinstance(D_bar, torch.Tensor):
        return D_bar.device
    return torch.device("cpu")


def init_w(net, D_bar, rng=None, *, device=None) -> Dict:
    """Feasible start: keep all data local, uniform BS->DC dispersion,
    aggregator = DC 0, mid-range compute settings.  On ``device``, else
    on ``D_bar``'s device (the CPU for a numpy ``D_bar``)."""
    del rng
    dev = _device_of(D_bar, device)
    N, B, S = net.dims
    cfg = net.cfg

    def full(shape, value):
        return torch.full(shape, float(value), device=dev)

    return {
        "rho_nb": full((N, B), 0.0) + 0.02,
        "rho_bs": full((B, S), 1.0) / S,
        "f_n": full((N,), 0.5 * (cfg.f_min + cfg.f_max)),
        "z_s": full((S,), 0.5 * cfg.dc_point_capacity),
        "gamma": full((N + S,), 2.0),
        "m": full((N + S,), 0.5),
        "I_s": full((S,), 1.0) / S,
        "I_nb": full((N, B), 1.0) / B,
        "I_bn": full((B, N), 1.0) / B,
        "R_bs": as_f32(net.R_bs_max).to(dev) * 0.5,
        "delta_A": full((), 50.0),
        "delta_R": full((), 5.0),
    }


def _running_sum_f32(u):
    """Running sum along dim 1, one float32 addition at a time: the
    rounding of the JAX package's ``jnp.cumsum``.  ``torch.cumsum`` on
    the CPU accumulates float32 in float64 (and on CUDA in no promised
    order), and a last-bit change in rho_bs can move an offloading
    floor."""
    return torch.stack(list(itertools.accumulate(u.unbind(1))), dim=1)


def _project_simplex(v, z=1.0):
    """Euclidean projection of rows of v onto {x >= 0, sum x = z}."""
    orig = v.shape
    v2 = v.reshape(-1, orig[-1])
    u = torch.flip(torch.sort(v2, dim=1).values, dims=(1,))
    css = _running_sum_f32(u) - z
    ind = torch.arange(1, orig[-1] + 1, dtype=v.dtype, device=v.device)
    cond = u - css / ind > 0
    rho = torch.sum(cond, dim=1)
    theta = torch.gather(css, 1, (rho - 1)[:, None])[:, 0] / rho
    return torch.clamp(v2 - theta[:, None], min=0.0).reshape(orig)


def _project_simplex_ineq(v, z=1.0):
    """Projection onto {x >= 0, sum x <= z}."""
    clipped = torch.clamp(v, min=0.0)
    over = torch.sum(clipped, dim=-1, keepdim=True) > z
    proj = _project_simplex(v, z)
    return torch.where(over, proj, clipped)


def project(w: Dict, net, gamma_cap: float = 20.0) -> Dict:
    cfg = net.cfg
    out = dict(w)
    dev = w["R_bs"].device
    out["rho_nb"] = _project_simplex_ineq(w["rho_nb"])          # (45),(55)
    out["rho_bs"] = _project_simplex(w["rho_bs"])               # (46),(56)
    out["I_s"] = _project_simplex(w["I_s"])                     # (47),(67)
    out["I_nb"] = _project_simplex(w["I_nb"])                   # (48),(68)
    out["I_bn"] = _project_simplex(w["I_bn"].T).T               # (49),(68)
    out["f_n"] = torch.clamp(w["f_n"], cfg.f_min, cfg.f_max)    # (57)
    out["z_s"] = torch.clamp(w["z_s"], 1e3, cfg.dc_point_capacity)  # (54)
    out["gamma"] = torch.clamp(w["gamma"], 0.5, gamma_cap)      # (59)
    out["m"] = torch.clamp(w["m"], 1e-3, 1.0)                   # (58)
    R = torch.minimum(torch.clamp(w["R_bs"], min=0.0),
                      as_f32(net.R_bs_max).to(dev))             # (14)
    tot = torch.sum(R, dim=0)
    scale = torch.clamp(as_f32(net.R_s_max).to(dev) / (tot + 1e-9),
                        max=1.0)
    out["R_bs"] = R * scale[None, :]                            # (15)
    out["delta_A"] = torch.clamp(w["delta_A"], min=0.0)         # (60)
    out["delta_R"] = torch.clamp(w["delta_R"], min=0.0)
    return out


class Scaler:
    """Normalize decision variables to O(1) so the isotropic proximal
    surrogate (eq. 83) is well-conditioned.  The physical<->normalized maps
    are linear, so convexity/feasibility arguments are unaffected."""

    def __init__(self, net, gamma_cap: float = 20.0, delta_A_scale=100.0,
                 delta_R_scale=10.0):
        cfg = net.cfg
        self.gamma_cap = gamma_cap
        self.scale = {
            "rho_nb": 1.0, "rho_bs": 1.0, "I_s": 1.0, "I_nb": 1.0,
            "I_bn": 1.0, "m": 1.0,
            "f_n": cfg.f_max,
            "z_s": cfg.dc_point_capacity,
            "gamma": gamma_cap,
            "R_bs": as_f32(net.R_bs_max),
            "delta_A": delta_A_scale,
            "delta_R": delta_R_scale,
        }

    def flat(self, spec: WSpec) -> torch.Tensor:
        """The (P,) per-component scale vector, on the device of the
        ``R_bs`` scale: physical = normalized * this, elementwise."""
        dev = self.scale["R_bs"].device
        return spec.flatten({
            k: torch.broadcast_to(as_f32(self.scale[k]).to(dev),
                                  spec.shapes[k]) for k in W_KEYS})


class NetView:
    """The solver's view of a ``Network``: its rate arrays as float32
    tensors on one device, beside ``cfg`` and ``dims``.  Duck-types the
    surface ``costs`` / ``project`` / ``Scaler`` read."""

    ARRAYS = ("R_nb", "R_bn", "R_ss", "R_sb", "R_bs_max", "R_s_max")

    def __init__(self, cfg, dims, arrays):
        self.cfg = cfg
        self._dims = tuple(int(d) for d in dims)
        for name, arr in zip(self.ARRAYS, arrays):
            setattr(self, name, arr)

    @property
    def dims(self):
        return self._dims

    @classmethod
    def from_network(cls, net, device=None) -> "NetView":
        """``net``'s rate arrays on ``device`` (default: the CPU, or the
        device ``net``'s arrays already live on)."""
        return cls(net.cfg, net.dims,
                   [as_f32(getattr(net, a)).to(device or _device_of(
                       getattr(net, a), None)) for a in cls.ARRAYS])


def one_hot(idx, n, *, device=None) -> torch.Tensor:
    """float32 one-hot rows of ``idx`` (a tensor keeps its device; an int
    lands on ``device``, default the CPU)."""
    if not isinstance(idx, torch.Tensor):
        idx = torch.tensor(idx, device=device or "cpu")
    return F.one_hot(idx, n).to(torch.float32)


def round_indicators(w: Dict) -> Dict:
    """Map relaxed indicators to feasible binaries (argmax rounding),
    satisfying (47)-(49) and (61)-(62)."""
    out = dict(w)
    S = w["I_s"].shape[0]
    out["I_s"] = one_hot(torch.argmax(w["I_s"]), S)
    out["I_nb"] = one_hot(torch.argmax(w["I_nb"], dim=1),
                          w["I_nb"].shape[1])
    out["I_bn"] = one_hot(torch.argmax(w["I_bn"], dim=0),
                          w["I_bn"].shape[0]).T
    return out
