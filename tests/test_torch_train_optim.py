"""The port's training pieces around the step, against the JAX package
where it has a counterpart:

(d) ``data.pipeline.lm_batch_at`` and every ``data.synthetic`` generator
    byte-equal to the reference's for the same seed and shape;
(e) ``optim.adamw_update`` and the schedules, fed identical gradients and
    steps: equal to float32 rounding (rtol 1e-6, atol 1e-7: both compute
    in float32, in the same order of operations);
(g) ``python -m repro_torch.launch.train --device cpu`` runs and its loss
    falls;
and, port only: remat "full" recomputes each block in the backward (the
kernel wrapper runs twice per layer) without changing the gradients, the
fault supervisor and watchdog, and the launcher's refusals.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.data import synthetic as jsyn
from repro.optim import adamw as jadamw
from repro.optim import schedule as jsched
from repro_torch.configs import get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.data import synthetic as tsyn
from repro_torch.distributed.fault import (StepFailure, StepWatchdog,
                                           SupervisorConfig, run_supervised)
from repro_torch.kernels import ops as kops
from repro_torch.launch import train as launch_train
from repro_torch.models.registry import get_model
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedule as tsched
from repro_torch.train.step import init_train_state, make_grad_fn
from repro_torch.tree import tree_leaves

FP32 = dict(rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("step", [0, 1, 17])
@pytest.mark.parametrize("hosts", [1, 2])
def test_lm_batch_at_is_byte_identical(step, hosts):
    for host in range(hosts):
        kw = dict(global_batch=4, seq_len=33, vocab_size=1000, seed=3,
                  num_hosts=hosts, host_index=host)
        ref = jpipe.lm_batch_at(jpipe.PipelineConfig(**kw), step)
        got = tpipe.lm_batch_at(tpipe.PipelineConfig(**kw), step)
        assert sorted(got) == sorted(ref) == ["labels", "tokens"]
        for key in ref:
            assert got[key].dtype == ref[key].dtype
            assert got[key].tobytes() == ref[key].tobytes()


@pytest.mark.parametrize("gen,args", [
    ("adding_problem", (3, 20, 5)), ("digits", (4, 6)),
    ("sentiment", (3, 7)), ("copy_words", (2, 8)),
    ("lm_tokens", (2, 16, 50, 9))])
def test_synthetic_generators_are_byte_identical(gen, args):
    ref, got = getattr(jsyn, gen)(*args), getattr(tsyn, gen)(*args)
    for r, g in zip(ref, got):
        assert g.dtype == r.dtype and g.tobytes() == r.tobytes()


def _tree(rng, scale=1.0):
    return {"a": {"kernel": (rng.normal(size=(5, 3)) * scale)
                  .astype(np.float32)},
            "b": (rng.normal(size=(7,)) * scale).astype(np.float32)}


@pytest.mark.parametrize("clip", [None, 1.0, 0.01])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_update_matches_reference(clip, weight_decay):
    """Three updates fed the same gradients on both sides."""
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, 0.3) for _ in range(3)]
    sched = (jsched.warmup_cosine(1e-2, 2, 10),
             tsched.warmup_cosine(1e-2, 2, 10))
    jcfg = jadamw.AdamWConfig(lr=sched[0], weight_decay=weight_decay,
                              grad_clip_norm=clip)
    tcfg = tadamw.AdamWConfig(lr=sched[1], weight_decay=weight_decay,
                              grad_clip_norm=clip)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadamw.init_adamw(jp, jcfg)
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), params)
    ts = tadamw.init_adamw(tp, tcfg)
    for g in grads:
        jp, js, jm = jadamw.adamw_update(jax.tree.map(jnp.asarray, g), js,
                                         jp, jcfg)
        tp2, ts, tm = tadamw.adamw_update(
            jax.tree.map(torch.from_numpy, g), ts, tp, tcfg)
        assert tp2 is tp                       # updated in place
        for got, ref in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FP32)
        for got, ref in zip(tree_leaves(ts.mu) + tree_leaves(ts.nu),
                            jax.tree.leaves(js.mu) + jax.tree.leaves(js.nu)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FP32)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), **FP32)
        if clip is not None:
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(jm["grad_norm"]), **FP32)
    assert int(ts.step) == int(js.step) == 3


@pytest.mark.parametrize("name,args", [
    ("warmup_cosine", (3e-4, 10, 100)), ("warmup_cosine", (1.0, 0, 5, 0.2)),
    ("warmup_linear", (3e-4, 10, 100)), ("warmup_linear", (2.0, 3, 3, 0.5)),
    ("constant", (0.125,))])
def test_schedules_match_reference(name, args):
    jf, tf = getattr(jsched, name)(*args), getattr(tsched, name)(*args)
    for s in (0, 1, 3, 9, 10, 11, 50, 99, 100, 250):
        ref = float(jf(jnp.asarray(s, jnp.int32)))
        for step in (s, torch.tensor(s, dtype=torch.int32)):
            got = tf(step)
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(float(got), ref, **FP32)


def test_launcher_trains_on_the_cpu_and_its_loss_falls(capsys):
    # 16 x 64 tokens a step: each of the reduced vocab's 256 tokens is
    # seen about 4 times a step, so its bigram is learnt within 20 steps
    assert launch_train.main(["--device", "cpu", "--steps", "20", "--batch",
                              "16", "--seq", "64", "--lr", "3e-2",
                              "--seed", "0"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    losses = out["losses"]
    assert out["device"] == "cpu" and out["restarts"] == 0
    assert len(losses) == 20 and all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1


@pytest.mark.parametrize("argv,match", [
    (["--ckpt-dir", "x"], "checkpoint/store.py"),
    (["--data-parallel", "2"], "queue 1 item 7"),
    (["--model-parallel", "2"], "queue 1 item 7")])
def test_launcher_refuses_what_is_not_ported(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        launch_train.run(["--device", "cpu", "--steps", "1"] + argv)


def test_launcher_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.run(["--steps", "1"])


@pytest.mark.parametrize("mech", ["inhibitor", "dotprod"])
def test_remat_full_recomputes_each_block_with_equal_gradients(mech):
    base = dataclasses.replace(
        get_config(f"smollm-135m@{mech}").reduced(), attention=dataclasses
        .replace(get_config(f"smollm-135m@{mech}").reduced().attention,
                 backend="pallas"))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, base.vocab_size, (2, 16)).astype(np.int32))
    batch = {"tokens": tokens, "labels": tokens.roll(-1, dims=1)}
    grads = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        api = get_model(cfg)
        params, _ = init_train_state(api, tadamw.AdamWConfig(),
                                     torch.Generator().manual_seed(0),
                                     device="cpu")
        kops.reset_counts()
        grads[remat], _ = make_grad_fn(api)(params, batch)
        plain = ("flash_inhibitor_plain" if mech == "inhibitor"
                 else "flash_attention_plain")
        per_layer = 2 if remat == "full" else 1
        assert kops.counts()[plain] == per_layer * cfg.num_layers
    for a, b in zip(tree_leaves(grads["full"]), tree_leaves(grads["none"])):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with pytest.raises(NotImplementedError, match="dots"):
        api = get_model(dataclasses.replace(base, remat="dots"))
        make_grad_fn(api)(init_train_state(
            api, tadamw.AdamWConfig(), torch.Generator().manual_seed(0),
            device="cpu")[0], batch)


def test_run_supervised_restarts_on_step_failure_only():
    calls = []

    def flaky(attempt):
        calls.append(attempt)
        if attempt < 2:
            raise StepFailure("nan")

    assert run_supervised(flaky, SupervisorConfig(max_restarts=3,
                                                  restart_backoff_s=0)) == 2
    assert calls == [0, 1, 2]
    with pytest.raises(StepFailure):
        run_supervised(flaky, SupervisorConfig(max_restarts=0,
                                               restart_backoff_s=0))
    with pytest.raises(ValueError):
        run_supervised(lambda a: (_ for _ in ()).throw(ValueError("x")),
                       SupervisorConfig(restart_backoff_s=0))


def test_step_watchdog_flags_stragglers_after_warmup():
    w = StepWatchdog(threshold=2.0, warmup_steps=3)
    flags = [w.observe(i, t) for i, t in enumerate(
        [1.0, 10.0, 1.0, 1.0, 1.0, 5.0, 1.0])]
    assert flags == [False, False, False, False, False, True, False]
    assert w.flagged[0][:2] == (5, 5.0)
