"""Dense-family layers as plain functions over dicts of tensors.

Parameters keep the reference's layouts (a dense kernel is
``(*in_shape, *out_shape)``), so a JAX parameter tree converts leaf for
leaf (:mod:`repro_torch.convert`).  Random init draws from a CPU
``torch.Generator`` and moves the result to the target device, so one
seed gives the same weights on every device.
"""
