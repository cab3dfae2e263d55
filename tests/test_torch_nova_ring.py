"""The launch plan and the ring schedule of ``csrc/nova_aggregate.cu``.

The kernel runs only on the card.  What surrounds it is Python and numpy
and is checked here at every path shape:

* :func:`repro_torch.kernels.nova_aggregate.launch_plan`, the plan the
  CUDA launch reads (tile, ring stages S, blocks, shared bytes): tiles
  cover the plane exactly once, 16-byte aligned and a multiple of 16
  bytes; S x tile plus the weight chunk fits a block's 227 KB and the
  blocks an SM take fit its 228 KB; S >= 1 and the grid is one wave of at
  most one block a tile.
* the producer / consumer index schedule (stage, parity and tile of every
  copy), vectorized over whole path shapes: every (tile, DPU) and (tile,
  replica) pair is consumed exactly once, in DPU order, and a stage is
  refilled only after the empty-barrier phase that the consumers of its
  previous copy complete.
* an emulation of the ring with mbarrier parities, copies landing late
  and warps interleaved at random, whose consumers compute the kernel's
  arithmetic from what they read out of the ring: it must equal the plain
  version (and, for one small shape, the Pallas kernel in interpret
  mode), so a stage read too early or refilled too soon shows as a wrong
  value.  f32 tolerance: two ulps of the largest operand plus theta_eta *
  n ulps of the largest d (the kernel's fmaf against numpy's rounded
  multiply and add).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.nova_aggregate import nova_aggregate_2d
from repro_torch.kernels import nova_aggregate as tna
from repro_torch.kernels import ref
from repro_torch.kernels.plane import LANE

SMS = 132                   # the H100 SXM's SMs
DPUS = [1, 2, 5, 6, 8, 11, 15, 20, 25, 64, 100, 12_289, 20_000]
ROWS = [8, 16, 176, 1_024, 126_080, 772_992]
ELEM_BYTES = {"f32": 4, "bf16": 2}


def _plan(n, R, dtype, form):
    replicas = n if form == "stacked" else 1
    return replicas, tna.launch_plan(n, replicas, R, ELEM_BYTES[dtype], SMS)


def _block_tiles(tiles, blocks, b):
    """The tiles block b walks: b, b + blocks, ... (the kernel's stride)."""
    return np.arange(b, tiles, blocks)


@pytest.mark.parametrize("form", ["one_plane", "stacked"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("n", DPUS)
def test_plan_fits_the_card_and_covers_the_plane(n, R, dtype, form):
    replicas, p = _plan(n, R, dtype, form)
    eb = ELEM_BYTES[dtype]
    plane = R * LANE
    tile_bytes = p.tile_elems * eb
    # tiles: whole 16-byte vectors, a whole number of consumer warps, at
    # 16-byte aligned offsets of every plane (planes are whole rows)
    assert p.tile_elems in tna.TILE_ELEMS
    assert tile_bytes % 16 == 0 and (plane * eb) % 16 == 0
    consumers = p.tile_elems * eb // 16
    assert consumers % tna.WARP == 0 and p.threads == consumers + tna.WARP
    assert p.threads <= 1024
    # every row of R exactly once: the blocks' strided tiles, in order,
    # are the plane's tiles
    tiles = plane // p.tile_elems
    assert tiles * p.tile_elems == plane
    assert 1 <= p.blocks <= tiles
    starts = np.sort(np.concatenate(
        [_block_tiles(tiles, p.blocks, b) for b in range(p.blocks)]))
    assert np.array_equal(starts, np.arange(tiles))
    rows = np.zeros(R, np.int64)
    np.add.at(rows, starts * p.tile_elems // LANE, 1)
    assert np.all(rows == LANE // p.tile_elems)
    assert np.all((starts * tile_bytes) % 16 == 0)
    # shared memory: the ring and the weight chunk fit a block, the
    # blocks an SM takes in one wave fit the SM, with its threads
    assert p.stages >= 1
    assert p.smem_bytes == tna.smem_bytes(n, p.stages, tile_bytes)
    assert (p.stages * tile_bytes + 4 * min(n, tna.KCHUNK)
            <= p.smem_bytes <= tna.SMEM_BLOCK)
    per_sm = -(-p.blocks // SMS)
    assert per_sm * (p.smem_bytes + tna.SMEM_RESERVED) <= tna.SMEM_SM
    assert per_sm * p.threads <= tna.THREADS_SM
    assert per_sm <= tna.BLOCKS_SM
    # the rings hold no more stages than a tile's copies, and about
    # IN_FLIGHT bytes an SM in all
    assert p.stages <= n + replicas
    assert p.stages == 1 or p.blocks * p.stages * tile_bytes <= (
        tna.IN_FLIGHT * SMS)


def _schedule(n, replicas, tiles, blocks, stages, b):
    """Copy k of block b, as the producer issues it: (tile, source c: the
    DPU c < n or the replica c - n, stage, parity of the ring's round)."""
    copies = n + replicas
    k = np.arange(len(_block_tiles(tiles, blocks, b)) * copies)
    tile = b + (k // copies) * blocks
    return tile, k % copies, k % stages, (k // stages) & 1


def _schedule_cases():
    """Every path shape whose schedule has at most 4M copies in all."""
    for n in DPUS:
        for R in ROWS:
            for dtype in ELEM_BYTES:
                for form in ("one_plane", "stacked"):
                    replicas, p = _plan(n, R, dtype, form)
                    tiles = R * LANE // p.tile_elems
                    if tiles * (n + replicas) <= 4_000_000:
                        yield n, R, dtype, form


@pytest.mark.parametrize("n,R,dtype,form", list(_schedule_cases()))
def test_schedule_consumes_every_pair_once_in_dpu_order(n, R, dtype, form):
    replicas, p = _plan(n, R, dtype, form)
    tiles = R * LANE // p.tile_elems
    copies = n + replicas
    seen = np.zeros((tiles, copies), np.int64)
    for b in range(p.blocks):
        tile, c, stage, parity = _schedule(n, replicas, tiles, p.blocks,
                                           p.stages, b)
        np.add.at(seen, (tile, c), 1)
        # consumers take copies in issue order: within a tile the sources
        # run d_0 .. d_{n-1}, then x_0 .. x_{replicas-1}
        per_tile = c.reshape(-1, copies)
        assert np.array_equal(per_tile, np.broadcast_to(
            np.arange(copies), per_tile.shape))
        # copy k refills stage k % S after the consumers released copy
        # k - S of the same stage, whose full-barrier parity the empty
        # barrier's completed phase carries: the producer waits on it with
        # parity (round - 1) & 1, which is its own parity flipped
        k = np.arange(len(c))
        later = k >= p.stages
        assert np.array_equal(stage[later], stage[k[later] - p.stages])
        assert np.array_equal(parity[later] ^ 1,
                              parity[k[later] - p.stages])
    assert np.all(seen == 1)


class _Barrier:
    """An mbarrier: arrivals and transaction bytes complete a phase;
    ``done(parity)`` is try_wait.parity (the phase of that parity, the
    current one's or the one before, has completed)."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.completed = count, count, 0, 0

    def done(self, parity):
        return (self.completed & 1) != parity

    def _complete(self):
        if self.pending == 0 and self.tx == 0:
            self.completed += 1
            self.pending = self.count

    def arrive(self, tx=0):
        self.pending -= 1
        self.tx += tx
        self._complete()

    def land(self, nbytes):
        self.tx -= nbytes
        self._complete()


def _emulate(x, d, w, theta_eta, tile_elems, stages, blocks, warps, seed):
    """The kernel's schedule on numpy: one producer and ``warps`` consumer
    warps per block, stepped in a random order, each bulk copy landing at
    a random later step.  Consumers read the ring's slots (which hold the
    copied values, or None once refilled in flight) and compute sum =
    w_j d_j + sum in DPU order from 0, then x_r - theta_eta * sum, in f32.
    Returns the output; raises on a read of a slot that was not filled by
    the copy the consumer expects."""
    rng = np.random.RandomState(seed)
    replicas, plane = x.shape[0], x.shape[1]
    n = d.shape[0]
    tiles = plane // tile_elems
    out = np.full_like(x, np.nan)
    for b in range(blocks):
        mine = _block_tiles(tiles, blocks, b)
        total = len(mine) * (n + replicas)
        full = [_Barrier(1) for _ in range(stages)]
        empty = [_Barrier(warps) for _ in range(stages)]
        ring = [None] * stages            # (copy index, values) or None
        flying = []                       # (copy index, stage, values)
        prod = {"k": 0, "s": 0, "phase": 0}
        cons = [{"k": 0, "s": 0, "phase": 0,
                 "sum": np.zeros(tile_elems, np.float32)}
                for _ in range(warps)]
        idle = 0                          # steps since the last move
        while prod["k"] < total or flying or any(
                c["k"] < total for c in cons):
            idle += 1
            if idle > 1000 * (warps + 2):
                raise AssertionError(f"block {b}: no actor can move (copy "
                                     f"{prod['k']} of {total} issued)")
            actor = rng.randint(warps + 2)
            if actor == warps and prod["k"] < total:      # the producer
                k, s = prod["k"], prod["s"]
                if k >= stages and not empty[s].done(prod["phase"] ^ 1):
                    continue
                t, c = mine[k // (n + replicas)], k % (n + replicas)
                src = d[c] if c < n else x[c - n]
                at = t * tile_elems
                full[s].arrive(tx=tile_elems)
                ring[s] = None            # the slot is being overwritten
                flying.append((k, s, src[at:at + tile_elems].copy()))
                prod["k"] += 1
                prod["s"] = (s + 1) % stages
                prod["phase"] ^= prod["s"] == 0
                idle = 0
            elif actor == warps + 1 and flying:           # a copy lands
                k, s, vals = flying.pop(rng.randint(len(flying)))
                idle = 0
                ring[s] = (k, vals)
                full[s].land(tile_elems)
            elif actor < warps and cons[actor]["k"] < total:
                cw = cons[actor]
                k, s = cw["k"], cw["s"]
                if not full[s].done(cw["phase"]):
                    continue
                if ring[s] is None or ring[s][0] != k:
                    raise AssertionError(f"block {b} warp {actor} read "
                                         f"stage {s} for copy {k}, found "
                                         f"{ring[s] and ring[s][0]}")
                vals = ring[s][1]
                t, c = mine[k // (n + replicas)], k % (n + replicas)
                if c == 0:
                    cw["sum"] = np.zeros(tile_elems, np.float32)
                if c < n:
                    cw["sum"] = np.float32(w[c]) * vals + cw["sum"]
                elif actor == 0:          # one warp writes (all agree)
                    at = t * tile_elems
                    out[c - n, at:at + tile_elems] = (
                        vals - np.float32(theta_eta) * cw["sum"])
                empty[s].arrive()
                cw["k"] += 1
                cw["s"] = (s + 1) % stages
                cw["phase"] ^= cw["s"] == 0
                idle = 0
    return out


@pytest.mark.parametrize("n,replicas,R,tile_elems,stages,blocks,warps", [
    (1, 1, 8, 1024, 1, 3, 2),       # one DPU, a ring of one stage
    (5, 1, 8, 512, 6, 5, 2),        # a tile's copies fill the ring
    (5, 1, 8, 256, 2, 7, 3),        # the ring wraps inside every tile
    (3, 3, 8, 1024, 4, 2, 4),       # stacked, rounds across tiles
    (25, 1, 8, 256, 26, 32, 2),     # the pinned n, one tile a block
    (64, 1, 8, 1024, 7, 4, 2),      # n > S: wraps many times a tile
    (11, 11, 16, 512, 5, 3, 3),     # stacked, S odd
])
def test_ring_emulation_equals_the_plain_version(n, replicas, R, tile_elems,
                                                 stages, blocks, warps):
    rng = np.random.RandomState(n * 101 + stages)
    x = rng.normal(size=(replicas, R * LANE)).astype(np.float32)
    d = rng.normal(size=(n, R * LANE)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, n).astype(np.float32)
    w = w / w.sum()
    got = _emulate(x, d, w, 0.2, tile_elems, stages, blocks, warps,
                   seed=stages * 7 + blocks)
    want = ref.nova_aggregate_ref(
        torch.from_numpy(x.reshape(replicas, R, LANE)),
        torch.from_numpy(d.reshape(n, R, LANE)), torch.from_numpy(w),
        0.2).numpy().reshape(replicas, -1)
    atol = (2 * np.spacing(np.abs(x).max())
            + 0.2 * n * np.spacing(np.abs(d).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_ring_emulation_equals_pallas():
    """The emulated ring at the plan of a small one-plane shape against
    ``nova_aggregate_2d`` in interpret mode."""
    n, R = 6, 8
    p = tna.launch_plan(n, 1, R, 4, SMS)
    rng = np.random.RandomState(5)
    x = rng.normal(size=(R, LANE)).astype(np.float32)
    d = rng.normal(size=(n, R, LANE)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, n).astype(np.float32)
    w = w / w.sum()
    got = _emulate(x.reshape(1, -1), d.reshape(n, -1), w, 0.07,
                   p.tile_elems, p.stages, p.blocks,
                   p.tile_elems // 4 // tna.WARP, seed=1)
    want = np.asarray(nova_aggregate_2d(jnp.asarray(x), jnp.asarray(d),
                                        jnp.asarray(w), 0.07,
                                        interpret=True))
    atol = 2 * np.spacing(np.abs(x).max()) + 0.07 * n * np.spacing(
        np.abs(d).max())
    np.testing.assert_allclose(got.reshape(R, LANE), want, rtol=0, atol=atol)


def test_plan_keeps_the_sm_count_per_device(monkeypatch):
    """The wrapper reads a device's SM count once, then from its cache."""
    calls = []

    class _Props:
        multi_processor_count = 132

    def props(idx):
        calls.append(idx)
        return _Props()

    monkeypatch.setattr(tna, "_SMS", {})
    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    assert tna.sm_count(torch.device("cuda", 3)) == 132
    assert tna.sm_count(torch.device("cuda", 3)) == 132
    assert calls == [3]


def test_plan_refuses_a_ring_past_a_block():
    """101 row tiles of 4 KB (a megabyte in flight an SM asks for all of
    a tile's copies) do not fit a block's 227 KB."""
    with pytest.raises(ValueError, match="shared memory"):
        tna.launch_plan(100, 1, 176, 4, SMS, tile_elems=1024,
                        in_flight=1 << 20)
