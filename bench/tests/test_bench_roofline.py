"""The frozen byte and operation counts against counts by hand."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from bench import roofline as rf

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("G,R,stacked,nbytes", [
    (25, 176, True, 4 * 176 * 1024 * 150),        # mesh path, per-DPU anchor
    (25, 176, False, 4 * 176 * 1024 * 126),       # sim path, shared anchor
    (2, 126080, True, 6_197_084_160),             # mamba2 plane
])
def test_fedprox_accum_bytes(G, R, stacked, nbytes):
    assert rf.fedprox_accum_bytes(G, R, stacked) == nbytes


def test_nova_aggregate_bytes():
    assert rf.nova_aggregate_bytes(25, 176, 1) == 4 * 176 * 1024 * 27
    assert rf.nova_aggregate_bytes(2, 126080, 2) == 12 * 2 * 126080 * 1024
    # 19.5 MB at 3.35 TB/s: 5.81 us; the mamba2 stack 0.925 ms
    assert abs(rf.bound_seconds(rf.nova_aggregate_bytes(25, 176, 1))
               - 5.81e-6) < 0.01e-6
    assert abs(rf.bound_seconds(rf.nova_aggregate_bytes(2, 126080, 2))
               - 0.925e-3) < 0.001e-3


def test_mlp_flops_by_hand():
    macs = 784 * 200 + 200 * 100 + 100 * 10
    assert rf.mlp_train_flops([784, 200, 100, 10], 3) == 6 * macs * 3


def test_mamba2_flops_by_hand():
    m = json.loads((ROOT / "bench" / "configs" / "mamba2_130m.json")
                   .read_text())
    d, di, N, P, H, Q, V = 768, 1536, 128, 64, 24, 64, 50280
    layer = 2 * d * (2 * di + 2 * N + H) + 2 * di * d \
        + 2 * Q * N + 2 * Q * H * P + 4 * H * P * N
    want = 24 * layer + 2 * d * V
    assert rf.mamba2_forward_flops_per_token(m, 512) == want
    assert rf.mamba2_train_flops(m, 512, 8192) == 3 * want * 8192
    # about 0.84 GFLOP a token
    assert 0.8e9 < 3 * want < 0.9e9


def test_kernel_share_needs_matching_records():
    from bench.trace import TraceData
    launch = {"kernel": "nova_aggregate", "n": 25, "R": 176, "replicas": 1,
              "elem_bytes": 4, "round": 0}
    bound = rf.launch_bound_seconds(launch)
    rec = ("void nova_aggregate_kernel<float>", 0.0, 2 * bound)
    data = TraceData([], {}, [launch], [rec], [0], (0.0, 1.0), {}, {}, {})
    assert abs(rf.kernel_share(data, "nova_aggregate",
                               "nova_aggregate_kernel") - 50.0) < 1e-9
    data.launches = []
    assert rf.kernel_share(data, "nova_aggregate",
                           "nova_aggregate_kernel") is None
