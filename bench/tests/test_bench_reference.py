"""The plain reference against the program at small sizes of both
configurations' shapes (group 2 and 4, RoPE bases 1e4 and 1e6, tied and
separate heads): a train step's loss, gradients and update, and prefill
then decode logits through the program's paged cache."""

from __future__ import annotations

import bench_tiny  # noqa: F401  (puts the program and the harness on the path)
import numpy as np
import pytest
import torch

from harness import cell as cells
from harness import checks, reference, train, weights

ARCHS = ["smollm-135m.inhibitor", "llava-next-mistral-7b.inhibitor"]
CPU = torch.device("cpu")


def _model(conf: str) -> dict:
    import json

    path = cells.ROOT / "bench" / "configs" / f"{conf}.json"
    return bench_tiny.tiny_model(json.loads(path.read_text()))


@pytest.mark.parametrize("conf", ARCHS)
def test_layout_is_the_programs(conf):
    from repro_torch.models.registry import get_model

    model = _model(conf)
    api = get_model(bench_tiny.program_config(model))
    meta = api.init(torch.Generator().manual_seed(0), device="meta")
    drawn = weights.draw(model, 3, CPU)
    assert weights.paths(drawn) == weights.paths(meta)
    assert [tuple(t.shape) for t in weights.leaves(drawn)] == \
        [tuple(t.shape) for t in weights.leaves(meta)]


@pytest.mark.parametrize("conf", ARCHS)
def test_draw_repeats_per_seed(conf):
    model = _model(conf)
    a, b = weights.draw(model, 7, CPU), weights.draw(model, 7, CPU)
    c = weights.draw(model, 8, CPU)
    assert all(torch.equal(x, y) for x, y in zip(weights.leaves(a),
                                                  weights.leaves(b)))
    assert not torch.equal(weights.leaves(a)[1], weights.leaves(c)[1])


@pytest.mark.parametrize("conf", ARCHS)
def test_train_step_matches_program(conf):
    from repro_torch.models.registry import get_model
    from repro_torch.optim import init_adamw
    from repro_torch.train.step import make_train_step

    model = _model(conf)
    model.setdefault("train", {
        "lr": 3e-4, "warmup_steps": 10, "total_steps": 100,
        "final_frac": 0.1, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
        "weight_decay": 0.1, "grad_clip_norm": 1.0, "remat": "full",
        "check_steps": 2})
    api = get_model(bench_tiny.program_config(model))
    mix = {"batch": 3, "seq_len": 40}
    params = {k: v for k, v in weights.draw(model, 5, CPU).items()}
    params = train._tree_map(
        lambda t: t.detach().clone().requires_grad_(True), params)
    cfg = train.opt_config(model["train"])
    opt = init_adamw(params, cfg)
    step = make_train_step(api, cfg)
    b = train.batch(mix, model, 5, 0, CPU)
    _, opt, m = step(params, opt, b)

    ref_params = train._tree_map(
        lambda t: t.detach().clone().requires_grad_(True),
        weights.draw(model, 5, CPU))
    leaves = weights.leaves(ref_params)
    loss = reference.loss(ref_params, model, b["tokens"], b["labels"])
    grads = reference.grads(loss, leaves)
    mu = [torch.zeros_like(t) for t in leaves]
    nu = [torch.zeros_like(t) for t in leaves]
    clipped = reference.adamw(leaves, list(grads), mu, nu, 1, model["train"])
    assert abs(float(m["loss"].detach()) - float(loss.detach())) < 1e-5
    # Adam's first update divides each gradient element by its own
    # magnitude, so an element near eps moves by up to the step's
    # learning rate (3e-5) on rounding: the update is held to a tenth of it
    for path, g, p, q in zip(weights.paths(params), clipped,
                             weights.leaves(params), leaves):
        got = train._at(opt.mu, path) / (1 - cfg.b1)
        torch.testing.assert_close(got, g, rtol=1e-4, atol=1e-7)
        torch.testing.assert_close(p.detach(), q.detach(), rtol=1e-5,
                                   atol=3e-6)


@pytest.mark.parametrize("conf", ARCHS)
def test_prefill_then_decode_logits_match(conf):
    from repro_torch.models.registry import get_model

    model = _model(conf)
    api = get_model(bench_tiny.program_config(model))
    params = weights.draw(model, 9, CPU)
    rng = np.random.default_rng(0)
    seq = rng.integers(0, model["vocab_size"], 37)
    prompt, decoded = seq[:29], seq[29:]
    states = api.init_states(1, 64, per_slot=True, paged=True, page_size=8,
                             device=CPU)
    kv = states.kv
    kv.block_tables[0] = torch.arange(1, 1 + kv.block_tables.shape[1]).flip(0)
    got = []
    with torch.no_grad():
        lg, states = api.step(params, torch.tensor(prompt[None]), states)
        got.append(lg[0])
        for t in decoded:
            lg, states = api.step(params, torch.tensor([[t]]), states)
            got.append(lg[0])
        want = reference.logits(params, model,
                                torch.tensor(seq[None], dtype=torch.int64))[0]
    torch.testing.assert_close(torch.cat(got), want[:len(seq)], rtol=1e-4,
                               atol=1e-4)


def test_served_gap_reads_the_reference():
    lg = torch.tensor([[0.0, 2.0, 1.0], [3.0, 0.5, 3.0]])
    assert checks.served_gap(lg, torch.tensor([1, 0])) == 0.0
    assert checks.served_gap(lg, torch.tensor([2, 1])) == 2.5


def test_worst_leaf_leaves_out_negligible_gradients():
    ref = {"losses": [1.0], "grad_norms": [1.0, 2.0, 1e-6],
           "change_norms": [1.0, 1.0, 1.0]}
    prog = {"losses": [1.25], "grad_norms": [1.0, 1.0, 5.0],
            "change_norms": [1.0, 1.5, 0.0]}
    r = checks.train_readings(prog, ref)
    assert r["loss_gap"] == 0.25
    assert r["grad_gap"] == 0.5          # leaf 2, the third left out
    assert r["change_gap"] == 0.5        # over the median leaf's norm


@pytest.mark.parametrize("change", [
    {"mechanism": "dot_product"}, {"signed": False},
    {"sliding_window": 256}, {"score_scale": "1"}, {"sink": 1},
    {"causal": "left out"}])
def test_reference_refuses_an_attention_it_does_not_implement(change):
    model = _model(ARCHS[0])
    reference.attention(model)
    model["attention"].update(change)
    model["attention"] = {k: v for k, v in model["attention"].items()
                          if v != "left out"}
    with pytest.raises(ValueError):
        reference.attention(model)


def test_attention_added_as_a_file_is_found(tmp_path, monkeypatch):
    (tmp_path / "halved.py").write_text(
        "HOLDS = {'causal': True}\nREADS = {'factor'}\n\n"
        "def attend(q, k, v, attention):\n"
        "    return q * attention['factor']\n")
    monkeypatch.setattr(reference, "ATTENTION", tmp_path)
    model = _model(ARCHS[0])
    model["attention"] = {"mechanism": "halved", "causal": True,
                          "factor": 0.5, "query_key_init_scale": 1}
    attend = reference.attention(model)
    assert float(attend(torch.ones(1), None, None, model["attention"])) == 0.5


def test_query_key_init_scale_is_the_configurations():
    model = _model(ARCHS[0])
    plain = dict(model, attention=dict(model["attention"],
                                       query_key_init_scale=1.0))
    a, b = weights.draw(model, 7, CPU), weights.draw(plain, 7, CPU)
    for path, x, y in zip(weights.paths(a), weights.leaves(a),
                          weights.leaves(b)):
        if path[-2] in ("wq", "wk"):
            torch.testing.assert_close(x * model["head_dim"] ** 0.5, y)
        else:
            assert torch.equal(x, y)
    with pytest.raises(ValueError):
        weights.draw(dict(model, attention=dict(
            model["attention"], query_key_init_scale="1/d")), 7, CPU)
