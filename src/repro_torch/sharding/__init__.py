"""The sharded parameter plane on a ``('dpu', 'rows')`` torch.distributed
mesh (counterpart of ``repro.sharding``)."""
from repro_torch.sharding.mesh import (  # noqa: F401
    DPU_AXIS, ROW_AXIS, plane_axes, plane_mesh, run_spmd,
)
from repro_torch.sharding.plane import (  # noqa: F401
    fedprox_accum_plane_sharded, local_round_plane_sharded,
    nova_aggregate_plane_sharded, robust_aggregate_plane_sharded,
)
from repro_torch.sharding.specs import sanitize_spec  # noqa: F401
