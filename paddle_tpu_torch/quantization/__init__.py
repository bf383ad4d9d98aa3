"""Quantized serving for the port: the serving face of the reference's
`paddle_tpu/quantization` (weight-only int8 params and int8 KV page
sizing).  The QAT/PTQ layer classes belong to a later slice."""
from .serving import (BLOCK_WEIGHT_KEYS, INT8_QMAX, KV_SCALE_DTYPE,  # noqa
                      SCALE_EPS, dequantize_weight, kv_page_bytes,
                      normalize_quant_dtype, quantize_serving_params,
                      quantize_weight)
