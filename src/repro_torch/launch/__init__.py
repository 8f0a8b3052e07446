"""Launch layer of the port: the H100 mesh constants and meshes, the
sharding rules as DTensor placements, the roofline count, and the
fake-process-group dry-runs (``python -m repro_torch.launch.dryrun``,
``python -m repro_torch.launch.reuse_dryrun``) — the JAX package's
``repro.launch``."""
from repro_torch.launch.mesh import (HBM_BW, ICI_BW, PEAK_FLOPS_BF16,
                                     make_debug_mesh, make_production_mesh)
from repro_torch.launch.sharding import ShardingRules, rules_for

__all__ = [
    "HBM_BW", "ICI_BW", "PEAK_FLOPS_BF16",
    "make_debug_mesh", "make_production_mesh",
    "ShardingRules", "rules_for",
]
