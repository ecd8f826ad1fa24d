"""The decoder-only families' layers (dense, MoE, Mamba, RWKV-6) as
plain functions over dicts of tensors, and the :class:`Param` box of
logical sharding axes (:mod:`repro_torch.nn.module`).

Parameters keep the reference's layouts (a dense kernel is
``(*in_shape, *out_shape)``, an expert stack ``(E, in, out)``), so a JAX
parameter tree converts leaf for leaf (:mod:`repro_torch.convert`).
Random init draws from the ``torch.Generator`` it is given, on that
generator's device, and moves the result to the target device: a CPU
generator gives the same weights on every device; a CUDA generator draws
billions of parameters on the card in a fraction of the time.
"""

from repro_torch.nn.module import (  # noqa: F401
    KeyGen,
    Param,
    axes_of,
    box_like,
    cast_params,
    fold_key,
    is_param,
    param_bytes,
    param_count,
    tree_map_params,
    unbox,
)
