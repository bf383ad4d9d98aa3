"""Attention functionals — port of `paddle_tpu/nn/functional/attention.py`.

`scaled_dot_product_attention` is the Paddle API entry: it goes to
`incubate.nn.functional.fused_dot_product_attention`, so a call with no
mask and no dropout at D 64/128/256 launches the flash kernels on the card.
"""
from __future__ import annotations


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """Inputs [B, L, H, D] (Paddle's layout)."""
    from ...incubate.nn.functional import fused_dot_product_attention
    return fused_dot_product_attention(query, key, value, attn_mask=attn_mask,
                                       dropout_p=dropout_p,
                                       is_causal=is_causal, training=training)
