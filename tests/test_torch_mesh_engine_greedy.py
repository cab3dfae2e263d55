"""The port's ``Engine(executor=MeshExecutor())`` against the JAX
package's under ``greedy_data`` (offloading to the DCs, mini-batch ratio
m = 0.5, so the leading-example mask cuts every DPU's data) and under
``fednova``; the sizes and tolerances and their reasons are in
``test_torch_mesh_engine.py``."""
from test_torch_mesh_engine import check_mesh_run_matches_jax


def test_greedy_data_mesh_run_matches_jax():
    check_mesh_run_matches_jax("greedy_data")


def test_fednova_mesh_run_matches_jax():
    """FedNova: no proximal term (a_k = 1) and theta = tau_eff."""
    check_mesh_run_matches_jax("fednova")
