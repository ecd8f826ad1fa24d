"""The frozen roofline arithmetic gives the bounds PERF.md has recorded
since the kernels were written."""

from __future__ import annotations

import bench_tiny  # noqa: F401
import pytest

from harness import roofline


def test_flash_inhibitor_bound_at_the_training_shape():
    b = roofline.flash_bound("flash_inhibitor", 8, 1024, 2, 9, 3, 64)
    assert b["bound_by"] == "operations"
    assert round(b["bound_ms"], 4) == 0.2893


def test_paged_bound_at_phase_4s_shape():
    # smollm-135m's decode shape: 8 rows at cursors 1 .. 512, page 16,
    # rows 5 and 6 sharing their first 10 pages (160 positions)
    lengths = [1, 15, 16, 17, 100, 300, 511, 512]
    tables, nxt = [], 1
    for ln in lengths:
        used = -(-ln // 16)
        tables.append(list(range(nxt, nxt + used)) + [0] * (32 - used))
        nxt += used
    tables[6][:10] = tables[5][:10]
    b = roofline.bound("paged_inhibitor", tables, lengths, heads=9,
                       kv_heads=3, d=64, elem=2)
    assert b["bound_by"] == "bytes"
    assert round(b["bound_ms"], 6) == 0.000306


def test_whole_steps():
    model = {"hidden_size": 576, "intermediate_size": 1536,
             "num_hidden_layers": 30, "num_attention_heads": 9,
             "num_key_value_heads": 3, "head_dim": 64, "vocab_size": 49152,
             "tie_word_embeddings": True}
    # 6 FLOPs a weight and token: about 6.6 TFLOP a step at b 8 x 1,024
    assert 6 * roofline.matmul_params(model) * 8192 == pytest.approx(
        6.61e12, rel=0.01)
    t = roofline.train_step_least_s(model, 8, 1024)
    assert 0.030 < t < 0.035
    # a decode step reads every float32 weight once at the least
    assert roofline.decode_least_s(model, [1]) == pytest.approx(
        roofline.stored_param_bytes(model) / roofline.HBM_BYTES_PER_S,
        rel=1e-3)
    assert roofline.prefill_least_s(model, 0, 32) >= \
        roofline.decode_least_s(model, [32])
