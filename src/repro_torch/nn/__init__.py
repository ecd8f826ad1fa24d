"""The decoder-only families' layers (dense, MoE, Mamba, RWKV-6) as
plain functions over dicts of tensors.

Parameters keep the reference's layouts (a dense kernel is
``(*in_shape, *out_shape)``, an expert stack ``(E, in, out)``), so a JAX
parameter tree converts leaf for leaf (:mod:`repro_torch.convert`).
Random init draws from the ``torch.Generator`` it is given, on that
generator's device, and moves the result to the target device: a CPU
generator gives the same weights on every device; a CUDA generator draws
billions of parameters on the card in a fraction of the time.
"""
