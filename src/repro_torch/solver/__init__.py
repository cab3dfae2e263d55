"""Counterpart of ``repro.solver``: problem P's variables, constraints and
objective, the SCA solver (Algorithms 1-3) and the greedy heuristics.
The reference's numpy oracle (``solver.ref``, ``solve_surrogate``) stays
in the JAX package."""
from repro_torch.solver.consensus import (  # noqa: F401
    consensus_error, consensus_rounds, consensus_scan, consensus_weights,
)
from repro_torch.solver.constraints import (  # noqa: F401
    constraint_vector, max_violation, num_constraints,
)
from repro_torch.solver.objective import (  # noqa: F401
    ObjectiveWeights, apply_required_deltas, ml_bound, objective,
    objective_breakdown,
)
from repro_torch.solver.primal_dual import PDHyper, make_surrogate  # noqa: F401
from repro_torch.solver.sca import SCAResult, solve  # noqa: F401
from repro_torch.solver import greedy, variables  # noqa: F401
