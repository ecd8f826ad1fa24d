"""The rank launcher: one process a rank of a cell's mesh.

``launch`` starts ``world`` processes with ``torch.multiprocessing``
(the "spawn" method: each rank imports afresh, so nothing of the parent's
CUDA state is shared), rank r on ``cuda:r`` in an NCCL group, or on the CPU
in a gloo group (the harness's CPU tests).  The group meets through a file
in a temporary directory of the run's own (``TMPDIR``), so no port is
picked.  Each rank runs ``fn(rank, device, *args)`` and leaves its
picklable result in that directory; ``launch`` waits for every rank to
end (a rank that raises ends the others, and the call raises) and returns
the results in rank order.  The parent touches no card while the ranks
run: each card holds one process.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Callable


def launch(fn: Callable, world: int, args: tuple, device_type: str) -> list:
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="bench-ranks-") as tmp:
        mp.start_processes(_entry, args=(world, tmp, device_type, fn, args),
                           nprocs=world, join=True, start_method="spawn")
        out = []
        for r in range(world):
            # the ranks' own results, written by _entry in this run
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _entry(rank: int, world: int, tmp: str, device_type: str, fn: Callable,
           args: tuple) -> None:
    import torch
    import torch.distributed as dist

    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        backend, kw = "nccl", {"device_id": device}
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
        backend, kw = "gloo", {}
    dist.init_process_group(backend, init_method=f"file://{tmp}/rendezvous",
                            world_size=world, rank=rank, **kw)
    try:
        out = fn(rank, device, *args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
