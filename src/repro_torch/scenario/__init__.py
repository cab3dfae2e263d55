"""Counterpart of ``repro.scenario``: per-round evolution of the CE-FL
world (mobility, handover, mesh churn, drift schedules, adversaries)."""
from repro_torch.scenario import presets  # noqa: F401  (registers the presets)
