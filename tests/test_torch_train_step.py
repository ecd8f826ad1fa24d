"""The port's train step (repro_torch.train.step) against the JAX
package's on converted parameters, with every attention call forced onto
the ``pallas`` backend on both sides: the JAX flash kernels in interpret
mode with their reference backward, the port's kernel wrappers (their
plain versions on the CPU) with the analytic / lean backward.

Reduced smollm-135m (2 layers, d_model 32, 4 / 2 heads of 16, vocab
128), batch 4 x seq 32 of ``lm_batch_at``, AdamW at a constant 1e-3.
For the inhibitor, wq and wk are scaled by 1/sqrt(head_dim) in both
trees so that Z is about 0.6 and attention is live (at unit scale every
inhibition, and every wq / wk gradient, is exactly 0).

One step with 1 and with 2 microbatches: the loss, and the gradients
through the AdamW moments (mu = 0.1 x the clipped gradient, nu = 0.05 x
its square), agree within 1e-4 relative (the norm of the difference of
each parameter's over its norm).  The updated parameters are not
compared element by element: Adam's first update is lr·g/(|g| + 1e-8),
so where |g| is within a few 1e-8 its size rests on g's last digits (the
update rule itself is held against the reference on identical gradients
in tests/test_torch_train_optim.py).  Then a 3-step loss trajectory
within 1e-4 relative.  Float32 on both sides: the residual is summation
order.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data.pipeline import PipelineConfig as JaxPipelineConfig
from repro.data.pipeline import lm_batch_at as jax_lm_batch_at
from repro.models.registry import get_model as jax_model
from repro.nn.module import unbox
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import init_adamw as jax_init_adamw
from repro.train.step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import PipelineConfig, lm_batch_at
from repro_torch.kernels import ops as kops
from repro_torch.models.registry import get_model
from repro_torch.optim.adamw import AdamWConfig, init_adamw
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_leaves

SMALL = dict(num_layers=2, d_model=32, d_ff=64, vocab_size=128)
LR = 1e-3
REL = 1e-4


def _pallas(cfg):
    return dataclasses.replace(cfg, attention=dataclasses.replace(
        cfg.attention, backend="pallas"))


@functools.lru_cache(maxsize=None)
def _setup(arch):
    jcfg = _pallas(jax_config(arch).reduced(**SMALL))
    tcfg = _pallas(get_config(arch).reduced(**SMALL))
    japi = jax_model(jcfg)
    jp = unbox(jax.jit(japi.init)(jax.random.PRNGKey(0)))
    if jcfg.attention.mechanism.startswith("inhibitor"):
        s = jcfg.attention.head_dim ** -0.5
        attn = dict(jp["blocks"]["attn"])
        for w in ("wq", "wk"):
            attn[w] = dict(attn[w], kernel=attn[w]["kernel"] * s)
        jp = dict(jp, blocks=dict(jp["blocks"], attn=attn))
    return jcfg, japi, jp, tcfg, get_model(tcfg)


def _port_state(arch):
    jcfg, _, jp, tcfg, _ = _setup(arch)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    return tp, init_adamw(tp, AdamWConfig(lr=LR))


@functools.lru_cache(maxsize=None)
def _jax_step(arch, microbatches):
    _, japi, _, _, _ = _setup(arch)
    return jax.jit(jax_make_train_step(japi, JaxAdamWConfig(lr=LR),
                                       microbatches))


def _batches(vocab, steps):
    pipe = dict(global_batch=4, seq_len=32, vocab_size=vocab, seed=0)
    return ([jax_lm_batch_at(JaxPipelineConfig(**pipe), s)
             for s in range(steps)],
            [lm_batch_at(PipelineConfig(**pipe), s) for s in range(steps)])


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["smollm-135m@inhibitor", "smollm-135m"])
def test_one_train_step_matches_reference(arch, microbatches):
    jcfg, _, jp, tcfg, tapi = _setup(arch)
    (jbatch,), (tbatch,) = _batches(tcfg.vocab_size, 1)
    jopt = jax_init_adamw(jp, JaxAdamWConfig(lr=LR))
    _, jopt1, jm = _jax_step(arch, microbatches)(
        jp, jopt, {k: jnp.asarray(v) for k, v in jbatch.items()})

    tp, topt = _port_state(arch)
    kops.reset_counts()
    tp1, topt1, tm = make_train_step(tapi, AdamWConfig(lr=LR),
                                     microbatches)(
        tp, topt, {k: torch.from_numpy(v) for k, v in tbatch.items()})
    plain = ("flash_inhibitor_plain" if arch.endswith("@inhibitor")
             else "flash_attention_plain")
    # every layer's forward went through the kernel wrapper
    assert kops.counts()[plain] == tcfg.num_layers * microbatches

    assert abs(float(tm["loss"]) - float(jm["loss"])) <= REL * abs(
        float(jm["loss"]))
    for ours, theirs in ((topt1.mu, jopt1.mu), (topt1.nu, jopt1.nu)):
        conv = params_from_jax(jax.tree.map(np.asarray, theirs), tcfg,
                               device="cpu")
        for got, ref in zip(tree_leaves(ours), tree_leaves(conv)):
            assert float(ref.abs().max()) > 0.0
            assert _rel(got.detach(), ref) <= REL
    attn_mu = topt1.mu["blocks"][0]["attn"]
    assert float(attn_mu["wq"]["kernel"].abs().max()) > 1e-6
    assert tp1 is tp and int(topt1.step) == int(jopt1.step) == 1


@pytest.mark.parametrize("arch", ["smollm-135m@inhibitor", "smollm-135m"])
def test_three_step_loss_trajectory_matches_reference(arch):
    _, _, jp, tcfg, tapi = _setup(arch)
    jbatches, tbatches = _batches(tcfg.vocab_size, 3)
    jstep = _jax_step(arch, 1)
    jopt = jax_init_adamw(jp, JaxAdamWConfig(lr=LR))
    tp, topt = _port_state(arch)
    tstep = make_train_step(tapi, AdamWConfig(lr=LR))
    jl, tl = [], []
    for jb, tb in zip(jbatches, tbatches):
        jp, jopt, jm = jstep(jp, jopt, {k: jnp.asarray(v)
                                        for k, v in jb.items()})
        tp, topt, tm = tstep(tp, topt, {k: torch.from_numpy(v)
                                        for k, v in tb.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=REL)
