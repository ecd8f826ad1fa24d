"""Serving: slot-pool continuous batching engine + KV cache management,
shared-prefix radix cache, and pluggable admission scheduling."""

from repro_torch.serve.engine import Engine, EngineConfig, Request  # noqa: F401
from repro_torch.serve.kvcache import (PagedAllocator,  # noqa: F401
                                       SlotAllocator, SlotState)
from repro_torch.serve.prefix import PrefixIndex  # noqa: F401
from repro_torch.serve.scheduler import (FIFOScheduler,  # noqa: F401
                                         PrefixAffinityScheduler,
                                         PriorityScheduler, Scheduler,
                                         make_scheduler, register_scheduler)
