"""Core: the paper's contribution — inhibitor attention — and its baseline,
behind the pluggable mechanism registry + backend planner."""

from repro_torch.core.attention import (  # noqa: F401
    AttentionConfig,
    KVCache,
    PagedKVCache,
    apply_attention,
    init_attention,
    init_kv_cache,
    init_paged_kv_cache,
)
from repro_torch.core.mechanism import (  # noqa: F401
    BACKENDS,
    MASK_FREE_BACKENDS,
    AttnShapes,
    ExecutionPlan,
    Mechanism,
    MechanismParams,
    PagedLayout,
    Structural,
    available_mechanisms,
    backend_eligible,
    execute_plan,
    get_mechanism,
    plan_attention,
    register_mechanism,
)
from repro_torch.core.dotprod import dot_product_attention  # noqa: F401
from repro_torch.core.lanes import (  # noqa: F401
    FheSimLane,
    FloatLane,
    IntLane,
    Lane,
    available_lanes,
    get_lane,
)
from repro_torch.core.inhibitor import (  # noqa: F401
    inhibit_fused,
    inhibit_naive,
    inhibit_signed_fused,
    inhibit_signed_naive,
    inhibitor_attention,
    inhibitor_attention_chunked,
    manhattan_scores,
)
