"""The fleet mesh and fleet-scale scoring on torch.distributed."""
from .mesh import fleet_mesh, fleet_sharding, pad_to_multiple, replicated  # noqa: F401
from .fleet import (  # noqa: F401
    COMBINE_ALL,
    COMBINE_ANY,
    fleet_summary,
    make_fleet_scorer,
    score_pairs,
)
