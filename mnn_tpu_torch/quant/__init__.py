"""Quantization: the packed per-block format (`quantize.py`) and the
offline tools (AWQ search, SmoothQuant, calibration, HQQ, OmniQuant)."""

from mnn_tpu_torch.quant.quantize import (
    QuantizedLinear,
    dequantize,
    matmul_dequant_ref,
    pack_int4,
    quantize,
    quantize_activations_int8,
    unpack_int4,
)
from mnn_tpu_torch.quant.awq_search import (
    awq_scale_block,
    search_clip,
    search_scale,
)

__all__ = [
    "QuantizedLinear",
    "awq_scale_block",
    "dequantize",
    "matmul_dequant_ref",
    "pack_int4",
    "quantize",
    "quantize_activations_int8",
    "search_clip",
    "search_scale",
    "unpack_int4",
]
