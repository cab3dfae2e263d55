"""The PyTorch port's engine against the JAX package's under ``fednova``
(no offloading, the fused one-group round), at the quickstart size; the
tolerances and their reasons are in ``test_torch_engine.py``."""
from test_torch_engine import check_run_matches_jax


def test_fednova_run_matches_jax(monkeypatch):
    check_run_matches_jax("fednova", True, monkeypatch)
