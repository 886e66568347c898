"""paddle_tpu_torch.quantization — weight-only quantization of the
decode matmuls (the counterpart of `paddle_tpu/quantization/
weight_only.py`).  The reference's QAT/PTQ toolchain (quanters,
observers, QAT, PTQ) is not ported yet."""
from .weight_only import (WEIGHT_ONLY_DTYPES, dequantize_weight,
                          packed_bytes, quantize_model, quantize_weight,
                          weight_pool_bytes)

__all__ = ["quantize_weight", "dequantize_weight", "quantize_model",
           "weight_pool_bytes", "packed_bytes", "WEIGHT_ONLY_DTYPES"]
