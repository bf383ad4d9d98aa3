"""`paddle.incubate.nn.functional` of the port — so far only
`fused_dot_product_attention` (reference
`paddle_tpu/incubate/nn/functional/__init__.py`), the function
`nn.functional.scaled_dot_product_attention` and `nn.MultiHeadAttention`
reach.  The other fused functions wait for their own slice."""
from __future__ import annotations

from ...kernels.flash_attention import flash_attention_fused
from ....core import generator as _gen
from ....core.tensor import apply


def fused_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                is_causal=False, training=True,
                                scaling_factor=None, name=None):
    """Fused SDPA over [B, S, H, D]: the flash kernels (rows 2, 5, 6) on the
    card where there is no mask and no dropout, `flash_attention_fused`'s
    counted plain route otherwise, the plain versions on the CPU.  Dropout
    draws from the port's generator for the query's device (the
    reference's `attention_ref`-style twin would drop it without one)."""
    p = dropout_p if training else 0.0

    def f(qq, kk, vv, *rest):
        gen = _gen.default_generator().torch_generator(qq.device) \
            if p > 0.0 else None
        return flash_attention_fused(qq, kk, vv,
                                     mask=rest[0] if rest else None,
                                     causal=is_causal, scale=scaling_factor,
                                     dropout_p=p, generator=gen)
    args = (q, k, v) + ((attn_mask,) if attn_mask is not None else ())
    return apply("fused_dot_product_attention", f, *args)
