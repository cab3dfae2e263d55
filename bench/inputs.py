"""The inputs the benchmark makes from ``--seed`` and hands, the same, to
the program and to the reference: the paper world (image pool, per-UE
arrivals, network rates), the LM token batches and the initial weights.

The laws are frozen copies of the program's own generators
(``repro_torch.data.synthetic``, ``repro_torch.core.drift.OnlineDataset``,
``repro_torch.network.topology.make_network``), so the traffic is the one
the paper presets describe, and a later change to the program cannot move
it.  Weights are drawn on the device in a few large calls.
"""
from __future__ import annotations

import numpy as np
import torch


def sub_seeds(seed: int, n: int) -> list:
    """``n`` independent 32-bit seeds from one run seed of any size."""
    return [int(s) for s in np.random.SeedSequence(int(seed)).generate_state(n)]


# --------------------------------------------------------- paper world --

def image_pool(num: int, shape, num_classes: int, seed: int,
               noise: float = 0.35):
    """Class-conditional structured images: ((train_x, train_y),
    (test_x, test_y)), the first fifth being the test split."""
    rng = np.random.RandomState(seed)
    H, W, C = shape
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    templates = []
    for _ in range(num_classes):
        f1, f2 = rng.uniform(0.5, 3.0, 2)
        p1, p2 = rng.uniform(0, 2 * np.pi, 2)
        t = np.sin(2 * np.pi * f1 * xx / W + p1) \
            * np.cos(2 * np.pi * f2 * yy / H + p2)
        templates.append(t[..., None] * rng.uniform(0.5, 1.0, (1, 1, C)))
    templates = np.stack(templates)
    y = rng.randint(0, num_classes, num)
    x = (templates[y] + noise * rng.randn(num, H, W, C)).astype(np.float32)
    n_test = num // 5
    return (x[n_test:], y[n_test:]), (x[:n_test], y[:n_test])


class Arrivals:
    """One UE's stream: each round ``sizes(t)[slot]`` new points drawn from
    the UE's label support, nothing retained.  ``step()`` returns the
    round's ``{"x", "y"}`` and keeps the pool indices in ``last_idx``."""

    def __init__(self, pool_x, pool_y, support, sizes, slot, seed):
        self.pool_x, self.pool_y = pool_x, pool_y
        self.support = np.asarray(support)
        self.sizes, self.slot = sizes, slot
        self._rng = np.random.RandomState(seed)
        self._by_label = {c: np.nonzero(pool_y == c)[0]
                          for c in range(int(pool_y.max()) + 1)}
        self._round = 0
        self.last_idx = None

    def step(self) -> dict:
        n_new = int(self.sizes(self._round)[self.slot])
        self._round += 1
        parts = np.array_split(np.arange(n_new), len(self.support))
        idx = np.concatenate([
            self._rng.choice(self._by_label[int(c)], size=len(p),
                             replace=True)
            for c, p in zip(self.support, parts) if len(p)])
        self.last_idx = idx
        return {"x": self.pool_x[idx], "y": self.pool_y[idx]}


def arrivals(pool_x, pool_y, *, num_ue, labels_per_ue, mean, std,
             seed) -> list:
    """The per-UE streams of App. G: each UE sees ``labels_per_ue`` of the
    classes, and N(mean, std) new points a round.  The round's counts are
    the same for every seed (drawn from the round number); the seed deals
    them out to the UEs in its own order, so every seed trains on as much
    data a round."""
    seeds = sub_seeds(seed, num_ue + 2)
    rng = np.random.RandomState(seeds[0])
    order = np.random.RandomState(seeds[1])
    num_classes = int(pool_y.max()) + 1
    dealt = {}

    def sizes(t):
        if t not in dealt:
            n = np.random.RandomState(t).normal(mean, std, num_ue)
            dealt[t] = order.permutation(np.maximum(1, n.astype(int)))
            dealt.pop(t - 2, None)
        return dealt[t]

    return [Arrivals(pool_x, pool_y,
                     rng.choice(num_classes, labels_per_ue, replace=False),
                     sizes, n, seeds[2 + n]) for n in range(num_ue)]


def _pathloss_gain(d_m):
    d_km = np.maximum(np.asarray(d_m, float), 1.0) / 1000.0
    return 10.0 ** (-(128.1 + 37.6 * np.log10(d_km)) / 10.0)


def _shannon(bw, power, gain, n0):
    return bw * np.log2(1.0 + power * gain / (n0 * bw))


def network_rates(net: dict, edge_prob: float = 0.3) -> dict:
    """The App. F-D testbed network of the ``network`` section of a
    configuration: rate arrays, subnets and the consensus graph, drawn
    from ``net["seed"]``."""
    rng = np.random.RandomState(net["seed"])
    N, B, S = net["num_ue"], net["num_bs"], net["num_dc"]
    sub_bs = np.minimum(np.arange(B) // max(1, B // S), S - 1)
    sub_ue = np.minimum(np.arange(N) // max(1, N // S), S - 1)
    gain = np.zeros((N, B))
    for n in range(N):
        for b in range(B):
            d = rng.uniform(50, 200) if sub_ue[n] == sub_bs[b] \
                else rng.uniform(400, 1200)
            gain[n, b] = _pathloss_gain(d) * rng.rayleigh(1.0) ** 2
    bw, n0 = net["bandwidth_hz"], net["noise_density"]
    R_nb = _shannon(bw, net["ue_tx_power"], gain, n0)
    R_bn = _shannon(bw, net["bs_tx_power"], gain.T, n0)

    def urange(lo_hi, shape):
        return rng.uniform(lo_hi[0], lo_hi[1], shape) * 1e9

    R_bs_max = urange(net["bs_dc_capacity_gbps"], (B, S))
    for b in range(B):
        R_bs_max[b, sub_bs[b]] *= 2.0
    R_s_max = urange(net["dc_capacity_gbps"], (S,))
    R_ss = urange(net["dc_dc_gbps"], (S, S))
    np.fill_diagonal(R_ss, np.inf)
    R_sb = R_bs_max.T * rng.uniform(1.0, 1.5, (S, B))
    V = N + B + S
    A = np.zeros((V, V), dtype=int)

    def add(i, j):
        A[i, j] = A[j, i] = 1
    for n in range(N):
        for b in range(B):
            if rng.rand() < edge_prob:
                add(n, N + b)
        for n2 in range(n + 1, N):
            if sub_ue[n] == sub_ue[n2] and rng.rand() < edge_prob:
                add(n, n2)
    for b in range(B):
        for s in range(S):
            if rng.rand() < edge_prob:
                add(N + b, N + B + s)
    for s in range(S):
        for s2 in range(s + 1, S):
            if rng.rand() < edge_prob:
                add(N + B + s, N + B + s2)
    for n in range(N):
        if not A[n, N:N + B].any():
            add(n, N + int(np.argmax(R_nb[n])))
    for b in range(B):
        if not A[N + b, N + B:].any():
            add(N + b, N + B + int(sub_bs[b]))
    for s in range(S):
        if not any(A[N + B + s, N + B + s2] for s2 in range(S) if s2 != s):
            add(N + B + s, N + B + ((s + 1) % S))
    return {"R_nb": R_nb, "R_bn": R_bn, "R_bs_max": R_bs_max,
            "R_s_max": R_s_max, "R_ss": R_ss, "R_sb": R_sb,
            "subnet_of_bs": sub_bs, "subnet_of_ue": sub_ue, "adjacency": A}


def classifier_weights(dims, seed: int, device) -> dict:
    """He-normal weights and zero biases of the MLP ``dims`` (input,
    hidden..., classes), in one draw on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes = [a * b for a, b in zip(dims[:-1], dims[1:])]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out, off = {}, 0
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        out[f"w{i}"] = flat[off:off + din * dout].view(din, dout) \
            * float(np.sqrt(2.0 / din))
        out[f"b{i}"] = torch.zeros(dout, device=device)
        off += din * dout
    return out


# ---------------------------------------------------------------- LM ----

def token_batch(vocab: int, n_dpu: int, mb: int, seq: int,
                seed: int) -> dict:
    """One round's tokens and labels, (n_dpu, 1, mb, seq) int32: a
    zipf(1.3) marginal folded into the vocabulary, labels the tokens
    shifted left by one (wrapping)."""
    rng = np.random.RandomState(seed)
    tokens = (rng.zipf(1.3, (n_dpu, 1, mb, seq)) % vocab).astype(np.int32)
    return {"tokens": tokens, "labels": np.roll(tokens, -1, axis=-1)}


def mamba2_dims(m: dict):
    d_inner = m["expand"] * m["d_model"]
    heads = d_inner // m["headdim"]
    d_conv = d_inner + 2 * m["ngroups"] * m["d_state"]
    d_in_proj = 2 * d_inner + 2 * m["ngroups"] * m["d_state"] + heads
    return d_inner, heads, d_conv, d_in_proj


def mamba2_weights(m: dict, seed: int, device) -> dict:
    """Random mamba2 LM weights in the program's tree (every block leaf
    stacked over the layers), float32, in three draws on ``device``:
    normal matrices scaled by 1/sqrt(fan-in) (embedding 0.02, conv 0.1),
    zero norms and biases, A = -(1..H), dt log-uniform in [dt_min,
    dt_max] with its inverse softplus as the bias."""
    gen = torch.Generator(device=device).manual_seed(seed)
    d, V, nl = m["d_model"], m["vocab_size"], m["n_layer"]
    d_inner, H, d_conv, d_in = mamba2_dims(m)
    W = m["d_conv"]
    shapes = [("embed", (V, d), 0.02), ("w_in", (nl, d, d_in), d ** -0.5),
              ("conv_w", (nl, W, d_conv), 0.1),
              ("w_out", (nl, d_inner, d), d_inner ** -0.5)]
    flat = torch.randn(sum(int(np.prod(s)) for _, s, _ in shapes),
                       generator=gen, device=device)
    mats, off = {}, 0
    for name, shape, scale in shapes:
        n = int(np.prod(shape))
        mats[name] = flat[off:off + n].view(shape) * scale
        off += n
    del flat
    u = torch.rand((nl, H), generator=gen, device=device)
    lo, hi = float(np.log(m["dt_min"])), float(np.log(m["dt_max"]))
    dt = torch.exp(u * (hi - lo) + lo)
    zeros = torch.zeros
    block = {
        "ln1": zeros((nl, d), device=device),
        "mamba": {
            "w_in": mats["w_in"], "conv_w": mats["conv_w"],
            "conv_b": zeros((nl, d_conv), device=device),
            "a_log": torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                            device=device)).repeat(nl, 1),
            "dt_bias": dt + torch.log(-torch.expm1(-dt)),
            "d_skip": torch.ones((nl, H), device=device),
            "norm": zeros((nl, d_inner), device=device),
            "w_out": mats["w_out"]}}
    return {"embed": mats["embed"], "final_norm": zeros((d,), device=device),
            "blocks": {"layer_0": block}}
