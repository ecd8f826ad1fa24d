"""Production mesh construction.

Port of :mod:`repro.launch.mesh`.  Functions, never module-level state:
a mesh is built over the current ``torch.distributed`` process group
(``init_device_mesh``), which the caller starts (``torchrun``, a spawned
test, the dry-run's fake group).  Its device type follows the group's
backend: ``cuda`` under NCCL, ``cpu`` otherwise.

Axis roles:
  pod   — data parallelism across pods (slow inter-pod links)
  data  — FSDP + batch sharding within a pod
  model — tensor/expert/sequence parallelism within a pod
"""

from __future__ import annotations


def _device_type() -> str:
    import torch.distributed as dist

    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape, names, device_type=None):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model"): the process group must hold 256 / 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_mesh(data: int, model: int, pods: int = 1, *, device_type=None):
    """Any mesh, e.g. (2, 2) on 4 ranks; ("pod", "data", "model") when
    ``pods`` > 1."""
    if pods > 1:
        return _mesh((pods, data, model), ("pod", "data", "model"),
                     device_type)
    return _mesh((data, model), ("data", "model"), device_type)
