"""Small copies of the benchmark's cells for the harness's CPU tests: the
cell's configuration file with small widths, and the program's
configuration cut to the same sizes (float32 compute, no remat)."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT / "src", ROOT / "bench"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

SIZES = {
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


def tiny_model(model: dict, size: str = "tiny") -> dict:
    m = copy.deepcopy(model)
    s = SIZES[size][m["arch"]]
    m.update(hidden_size=s["d"], intermediate_size=s["ff"],
             num_hidden_layers=s["layers"], vocab_size=s["v"],
             num_attention_heads=s["h"], num_key_value_heads=s["hk"],
             head_dim=s["hd"])
    if m.get("frontend_embed_dim"):
        m["frontend_embed_dim"] = 32
    return m


def program_config(model: dict, size: str = "tiny"):
    from repro_torch.configs import get_config

    s = SIZES[size][model["arch"]]
    cfg = get_config(model["arch"]).reduced(
        num_layers=s["layers"], d_model=s["d"], d_ff=s["ff"],
        vocab_size=s["v"], num_heads=s["h"], num_kv_heads=s["hk"],
        head_dim=s["hd"], max_seq_len=4096)
    if model.get("frontend_embed_dim"):
        import dataclasses

        cfg = dataclasses.replace(cfg, frontend=dataclasses.replace(
            cfg.frontend, embed_dim=32))
    return cfg


def tiny_cell(name: str, size: str = "tiny", **mix):
    """The cell ``name`` at a small size, its mix updated with ``mix``;
    returns (cell, the program's configuration)."""
    from harness import cell as cells

    c = cells.load(name)
    c.model = tiny_model(c.model, size)
    if c.mix["generator"] == "lm_stream":
        c.mix.update(batch=4, seq_len=48)
    else:
        c.model["serve"].update(max_batch=4, max_len=256)
        c.mix.update(prompt_len=[8, 100], output_len=[4, 24])
        if c.mix.get("rate"):
            c.mix.update(rate=25.0, ramp_s=0.5)
        else:
            c.mix.update(queue_depth=4)
    c.mix.update(mix)
    return c, program_config(c.model, size)
