"""Objective weights of problem P (paper eq. 44) and the feasible-point
delay budgets.  Counterpart of ``ObjectiveWeights`` and
``apply_required_deltas`` in ``repro.solver.objective``."""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.network import costs as C


@dataclasses.dataclass(frozen=True)
class ObjectiveWeights:
    xi1: float = 1.0          # ML performance weight
    xi2: float = 1e-2         # delay weight
    xi3: float = 1e-3         # energy weight
    xi3_sub: tuple = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0)   # xi_{3,1..6}
    eta: float = 1e-2
    mu: float = 0.01
    theta: float = 1.0
    T: int = 50
    drift: float = 0.3        # Delta_i (Table III default)


def apply_required_deltas(w: Dict, net, D_bar, slack: float = 1.0) -> Dict:
    """Overwrite the delay budgets delta^A / delta^R with the realized path
    requirements (eqs. 34/40) times ``slack`` — the feasible-point
    construction the baseline strategies share."""
    c = C.network_costs(w, net, D_bar)
    w = dict(w)
    w["delta_A"] = c["delta_A_req"] * slack
    w["delta_R"] = c["delta_R_req"] * slack
    return w
