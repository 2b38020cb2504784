"""AFL core: analytic (closed-form) federated learning (port of ``repro.core``).

Engine (ONE implementation of the math): :mod:`repro_torch.core.engine`
Host path (float64, paper-literal API):  :mod:`repro_torch.core.analytic`
Device path (f32 tensors on the card):   :mod:`repro_torch.core.streaming`
Non-linear feature maps (paper §5):      :mod:`repro_torch.core.features`
Sharded aggregation (a shard mesh):      :mod:`repro_torch.core.distributed`
"""

from repro_torch.core.engine import (  # noqa: F401
    AnalyticEngine,
    SuffStats,
)
from repro_torch.core.analytic import (  # noqa: F401
    ClientUpdate,
    aa_merge,
    afl_aggregate,
    aggregate_pairwise,
    aggregate_sufficient_stats,
    local_stage,
    ridge_solve,
    ri_restore,
)
from repro_torch.core.streaming import (  # noqa: F401
    AnalyticState,
    init_state,
    merge_states,
    solve,
    update_state,
)
from repro_torch.core.distributed import (  # noqa: F401
    ShardGroup,
    federated_solve,
    federation_mesh,
    make_federated_solve,
    make_tiled_federated_solve,
    psum_state,
    psum_stats,
)
