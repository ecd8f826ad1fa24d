"""Quantization: fake-quant (QAT) and integer inference paths."""

from repro_torch.quant.fake_quant import (  # noqa: F401
    QuantConfig,
    dequantize,
    fake_quant,
    quantize,
    quantize_params,
)
from repro_torch.quant.int_attention import (  # noqa: F401
    int_dot_product_attention,
    int_inhibitor_attention,
    lane_attention_heads,
    lane_dot_product_attention,
    lane_inhibitor_attention,
    quantize_qkv,
)
from repro_torch.quant.ptq import PtqConfig, QuantizedLM, ptq_lm  # noqa: F401
