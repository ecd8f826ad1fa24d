"""Optimizers, schedules, gradient compression."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    init_adamw,
)
from repro_torch.optim.compress import (  # noqa: F401
    CompressionState,
    compress_tree,
    decompress_tree,
    init_compression,
)
from repro_torch.optim.schedule import (  # noqa: F401
    constant,
    warmup_cosine,
    warmup_linear,
)
