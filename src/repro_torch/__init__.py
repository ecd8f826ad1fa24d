"""PyTorch port of :mod:`repro` for NVIDIA Hopper (H100).

Mirrors the JAX package's subpackage layout and module names: the
counterpart of ``repro/x/y.py`` is ``repro_torch/x/y.py``.  This package
imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.

Entry points (model construction, the serving ``Engine``, the serve
launcher) run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card present and none named, they raise (:func:`repro_torch.device.
resolve_device`).  The paged decode kernels are hand-written CUDA C++
(``csrc/paged_decode.cu``), built at first use.
"""
