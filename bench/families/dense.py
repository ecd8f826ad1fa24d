"""The dense and vlm families: a Llama-shaped decoder (SmolLM, Mistral, the
language model of LLaVA-NeXT) with the configuration's attention.

The reference follows the published description and reads its sizes from
the configuration file, never from the program:

* RMSNorm: x / sqrt(mean(x^2) + eps) * scale;
* rotary embeddings, "rotate half", at absolute positions, base
  ``rope_theta``;
* grouped-query attention: query head i reads kv head i // (h / h_kv);
* the attention the configuration names (``reference.attention``);
* the gated-SiLU MLP, a tied or separate head;
* the mean token cross-entropy.

Each layer's parameters may lie on a device of their own: the residual
stream follows them by ``.to()``, and the final norm and head by the same.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from harness.reference import _mm, _round, attention, device_of, rmsnorm, rope

EMBED_STD = 0.02

# the harness's CPU tests run these sizes of each arch
SMALL = {
    "tiny": {
        # a smollm-shaped copy: tied head, RoPE base 1e4, group 2
        "smollm-135m@inhibitor": dict(layers=2, d=64, ff=128, v=256, h=4,
                                      hk=2, hd=16),
        # a llava-shaped copy: separate head, RoPE base 1e6, group 4
        "llava-next-mistral-7b@inhibitor": dict(layers=2, d=64, ff=160,
                                                v=320, h=8, hk=2, hd=8),
    },
    # where the float8 control is read: smollm at its published widths,
    # both at 4 layers and a vocabulary of 8,192 / 4,096
    "control": {
        "smollm-135m@inhibitor": dict(layers=4, d=576, ff=1536, v=8192, h=9,
                                      hk=3, hd=64),
        "llava-next-mistral-7b@inhibitor": dict(layers=4, d=256, ff=640,
                                                v=4096, h=8, hk=2, hd=32),
    },
}


def check(model: dict, cfg) -> None:
    """Hold the program's configuration ``cfg`` of ``model["arch"]`` to
    every size the configuration file states."""
    a = cfg.attention
    stated = {
        "num_hidden_layers": cfg.num_layers, "hidden_size": cfg.d_model,
        "intermediate_size": cfg.d_ff, "vocab_size": cfg.vocab_size,
        "num_attention_heads": a.num_heads,
        "num_key_value_heads": a.num_kv_heads, "head_dim": a.head_dim,
        "rope_theta": a.rope_base, "rms_norm_eps": cfg.norm_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
        "param_dtype": cfg.param_dtype, "compute_dtype": cfg.compute_dtype,
    }
    held = {"mechanism": a.mechanism, "score_shift": a.score_shift,
            "normalize": a.normalize, "causal": a.causal,
            "sliding_window": a.sliding_window, "norm": cfg.norm,
            "mlp": cfg.mlp, "remat": cfg.remat}
    want = dict(model["attention"], norm="rmsnorm", mlp="gated_silu",
                remat=model.get("train", {}).get("remat", cfg.remat))
    bad = {k: (v, model[k]) for k, v in stated.items() if model[k] != v}
    bad.update({k: (held[k], want[k]) for k in held if k in want
                and held[k] != want[k]})
    if bad:
        raise SystemExit(f"bench: the program's {model['arch']} differs from "
                         f"the configuration file: {bad}")


def layout(model: dict) -> List[Tuple[tuple, tuple, str]]:
    """[(path, shape, init)] of the dense and vlm families' parameters, in
    the program's tree: ``init`` is "fan_in:<n>", "std:<s>", "ones" or
    "zeros"."""
    d, ff, v = (model["hidden_size"], model["intermediate_size"],
                model["vocab_size"])
    h, hk, hd = (model["num_attention_heads"], model["num_key_value_heads"],
                 model["head_dim"])
    out = []
    for i in range(model["num_hidden_layers"]):
        blk = ("blocks", i)
        out += [
            (blk + ("ln1", "scale"), (d,), "ones"),
            (blk + ("attn", "wq", "kernel"), (d, h, hd), f"fan_in:{d}"),
            (blk + ("attn", "wk", "kernel"), (d, hk, hd), f"fan_in:{d}"),
            (blk + ("attn", "wv", "kernel"), (d, hk, hd), f"fan_in:{d}"),
            (blk + ("attn", "wo", "kernel"), (h, hd, d), f"fan_in:{h * hd}"),
            (blk + ("ln2", "scale"), (d,), "ones"),
            (blk + ("ffn", "wg", "kernel"), (d, ff), f"fan_in:{d}"),
            (blk + ("ffn", "wu", "kernel"), (d, ff), f"fan_in:{d}"),
            (blk + ("ffn", "wd", "kernel"), (ff, d), f"fan_in:{ff}"),
        ]
    out.append((("embed", "table"), (v, d), f"std:{EMBED_STD}"))
    out.append((("final_norm", "scale"), (d,), "ones"))
    if not model["tie_word_embeddings"]:
        out.append((("lm_head", "kernel"), (d, v), f"fan_in:{d}"))
    fe = model.get("frontend_embed_dim")
    if fe:
        out.append((("frontend_proj", "kernel"), (fe, d), f"fan_in:{fe}"))
        out.append((("frontend_proj", "bias"), (d,), "zeros"))
    return out


def _block(p: dict, model: dict, attend, x, positions, prec):
    b, s, d = x.shape
    h, hk, hd = (model["num_attention_heads"], model["num_key_value_heads"],
                 model["head_dim"])
    eps, base = model["rms_norm_eps"], model["rope_theta"]
    a = p["attn"]
    y = rmsnorm(x, p["ln1"]["scale"], eps)
    q = _mm(y, a["wq"]["kernel"].reshape(d, h * hd), prec).view(b, s, h, hd)
    k = _mm(y, a["wk"]["kernel"].reshape(d, hk * hd), prec).view(b, s, hk, hd)
    v = _mm(y, a["wv"]["kernel"].reshape(d, hk * hd), prec).view(b, s, hk, hd)
    q, k = rope(q, positions, base), rope(k, positions, base)
    o = attend(_round(q, prec), _round(k, prec), _round(v, prec),
               model["attention"])
    x = x + _mm(o.reshape(b, s, h * hd), a["wo"]["kernel"].reshape(h * hd, d),
                prec)
    y = rmsnorm(x, p["ln2"]["scale"], eps)
    f = p["ffn"]
    g = F.silu(_mm(y, f["wg"]["kernel"], prec)) * _mm(y, f["wu"]["kernel"],
                                                       prec)
    return x + _mm(g, f["wd"]["kernel"], prec)


def logits(params: dict, model: dict, tokens: torch.Tensor,
           prec: Optional[str] = None) -> torch.Tensor:
    """tokens (b, s) -> float32 logits (b, s, V), positions 0 .. s - 1."""
    x = params["embed"]["table"][tokens.long()].float()
    attend = attention(model)
    for p in params["blocks"]:
        x = x.to(device_of(p))
        positions = torch.arange(tokens.shape[1], device=x.device)
        x = _block(p, model, attend, x, positions, prec)
    x = x.to(device_of(params["final_norm"]))
    x = rmsnorm(x, params["final_norm"]["scale"], model["rms_norm_eps"])
    head = (params["embed"]["table"].t() if model["tie_word_embeddings"]
            else params["lm_head"]["kernel"])
    return _mm(x.to(head.device), head, prec)


def loss(params, model, tokens, labels, prec=None) -> torch.Tensor:
    lg = logits(params, model, tokens, prec)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           labels.to(lg.device).reshape(-1).long())


def small(model: dict, size: str) -> dict:
    """The configuration file ``model`` at the size ``size`` of its arch."""
    m = copy.deepcopy(model)
    s = SMALL[size][m["arch"]]
    m.update(hidden_size=s["d"], intermediate_size=s["ff"],
             num_hidden_layers=s["layers"], vocab_size=s["v"],
             num_attention_heads=s["h"], num_key_value_heads=s["hk"],
             head_dim=s["hd"])
    if m.get("frontend_embed_dim"):
        m["frontend_embed_dim"] = 32
    return m


def small_program(model: dict, size: str):
    """The program's configuration of ``model["arch"]`` cut to ``size``
    (float32 compute, no remat)."""
    from repro_torch.configs import get_config

    s = SMALL[size][model["arch"]]
    cfg = get_config(model["arch"]).reduced(
        num_layers=s["layers"], d_model=s["d"], d_ff=s["ff"],
        vocab_size=s["v"], num_heads=s["h"], num_kv_heads=s["hk"],
        head_dim=s["hd"], max_seq_len=4096)
    if model.get("frontend_embed_dim"):
        cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(
            cfg.frontend, embed_dim=32))
    return cfg
