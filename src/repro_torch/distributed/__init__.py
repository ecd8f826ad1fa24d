"""Distribution layer: sharding rules over DTensor, collectives,
pipeline, fault tolerance."""

from repro_torch.distributed.sharding import (  # noqa: F401
    ACT_RULES,
    PARAM_RULES,
    batch_spec,
    constrain,
    current_mesh,
    param_sharding,
    param_spec,
    use_mesh,
)
