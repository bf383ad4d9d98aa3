"""Weight-only int8 serving params and int8 KV page sizing — the port's own
copy of `paddle_tpu/quantization/serving.py` (numpy there, torch here).

Two knobs of `LLMEngine(weight_dtype=, kv_dtype=)`:

- **Weight-only int8** (`quantize_serving_params`): symmetric per-channel
  PTQ of every serving matmul weight — `blocks.{qkv,proj,fc1,fc2,fcg}_w`,
  the embedding/head `wte` and an untied `lm_head`.  A quantized leaf `w`
  becomes the pair `w_q` (int8) + `w_scale` (float32, keeping `w`'s rank)
  with the reference's shapes: `[L, 1, out]` for block weights, `[V, 1]`
  for `wte`, `[1, V]` for `lm_head`.  `models.gpt._w` dequantizes one
  layer's weight at its matmul.
- **int8 KV pages** (`models.gpt.init_paged_cache(kv_dtype="int8")`):
  int8 k/v plus per-token, per-kv-head float32 scale lanes; `kv_page_bytes`
  sizes one page of either pool.

The math is the reference's, bit for bit: absmax in float32 over the
reduced axes, `max(absmax, 1e-30) / 127`, then `clip(round(w / scale),
-127, 127)` (`torch.round`, like `np.round`, rounds half to even).  It runs
in torch on the weights' own device, one layer of a stacked weight at a
time, so a Llama-3-8B `fc1_w` never has a float32 copy.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

INT8_QMAX = 127.0
# scale floor: a zero channel or token divides by it, not by zero
SCALE_EPS = 1e-30

# the serving matmul weights of the stacked blocks, each [L, in, out] with
# its channel (non-contracting) axis last
BLOCK_WEIGHT_KEYS = ("qkv_w", "proj_w", "fc1_w", "fc2_w", "fcg_w")

KV_SCALE_DTYPE = torch.float32


def quantize_weight(w: torch.Tensor, channel_axis):
    """Symmetric per-channel int8 PTQ of one weight.  `channel_axis` (an int
    or tuple) names the dims that keep their own scale; the others are
    reduced.  Returns (q int8, scale float32), scale of `w`'s rank with
    size 1 on every reduced dim."""
    keep = (channel_axis,) if isinstance(channel_axis, int) else \
        tuple(channel_axis)
    axes = tuple(i for i in range(w.dim()) if i not in keep)
    w = w.float()
    absmax = w.abs().amax(dim=axes, keepdim=True) if axes else w.abs()
    scale = torch.clamp(absmax, min=SCALE_EPS) / INT8_QMAX
    q = torch.clamp(torch.round(w / scale), -INT8_QMAX, INT8_QMAX) \
        .to(torch.int8)
    return q, scale


def dequantize_weight(q, scale, dtype=torch.float32):
    """Inverse of `quantize_weight` (the math of `models.gpt._deq`)."""
    return (q.float() * scale.float()).to(dtype)


def _quantize_stacked(w: torch.Tensor):
    """Per (layer, output channel) over a stacked [L, in, out] weight, one
    layer at a time.  Returns (q [L, in, out] int8, scale [L, 1, out])."""
    L, _, out = w.shape
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((L, 1, out), dtype=torch.float32, device=w.device)
    for l in range(L):
        q[l], scale[l] = quantize_weight(w[l], channel_axis=1)
    return q, scale


def quantize_serving_params(params: Dict[str, Any], config
                            ) -> Dict[str, Any]:
    """Weight-only int8 PTQ of a `models.gpt` parameter dictionary: each
    serving matmul weight `name` is replaced by `name_q` + `name_scale`;
    biases, norms and other leaves pass through as the same tensors.
    Returns a new dictionary on the params' device."""
    del config      # the keys alone decide what is quantized
    out: Dict[str, Any] = {}
    for name, leaf in params.items():
        if name == "blocks":
            blocks: Dict[str, Any] = {}
            for k, w in leaf.items():
                if k in BLOCK_WEIGHT_KEYS:
                    blocks[k + "_q"], blocks[k + "_scale"] = \
                        _quantize_stacked(w)
                else:
                    blocks[k] = w
            out["blocks"] = blocks
        elif name == "wte":
            out["wte_q"], out["wte_scale"] = quantize_weight(leaf, 0)
        elif name == "lm_head":
            out["lm_head_q"], out["lm_head_scale"] = quantize_weight(leaf, 1)
        else:
            out[name] = leaf
    return out


def normalize_quant_dtype(value: Optional[str], knob: str) -> Optional[str]:
    """None and the fp names mean off, "int8" on; anything else raises."""
    if value in (None, "fp", "fp32", "f32", "bf16", "bfloat16", "float32"):
        return None
    if value == "int8":
        return "int8"
    raise ValueError(f"{knob} must be None/'bf16' (off) or 'int8', "
                     f"got {value!r}")


def kv_page_bytes(config, page_size: int,
                  kv_dtype: Optional[str] = None) -> int:
    """Bytes one page takes across all layers: k + v, plus the per-token
    scale lanes of an int8 pool."""
    L, KVH, hd = config.num_layers, config.kv_heads, config.head_dim
    if normalize_quant_dtype(kv_dtype, "kv_dtype") == "int8":
        per_tok = hd + KV_SCALE_DTYPE.itemsize
    else:
        per_tok = hd * config.dtype.itemsize
    return 2 * L * page_size * KVH * per_tok
