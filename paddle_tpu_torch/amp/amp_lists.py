"""AMP op lists — a copy of `paddle_tpu/amp/amp_lists.py` (reference:
`python/paddle/amp/amp_lists.py:98`).

White list: matmul-class ops that run in bf16 on the tensor cores.
Black list: numerically sensitive ops kept in fp32.  The lists act through
`core.tensor.apply`'s op names, which the port keeps equal to the
reference's; `flash_attn` matches no such name (the entries are named
`flash_attention` and `flash_attn_unpadded`), so those stay gray, as in the
reference.
"""

WHITE_LIST = {
    "matmul", "mm", "bmm", "mv", "linear", "conv1d", "conv2d", "conv3d",
    "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "einsum", "addmm",
    "fused_dot_product_attention", "flash_attn",
}

BLACK_LIST = {
    "exp", "square", "log", "log2", "log10", "log1p", "mean", "sum", "cos_sim",
    "softmax", "log_softmax", "softmax_with_cross_entropy", "cross_entropy",
    "sigmoid_cross_entropy_with_logits", "bce_with_logits", "c_softmax_with_cross_entropy",
    "layer_norm", "batch_norm", "group_norm", "instance_norm", "rms_norm",
    "reduce_sum", "linear_interp", "nll_loss", "mse_loss", "l1_loss", "kl_div",
    "logsumexp", "erfinv", "pow", "norm", "var", "std", "renorm",
}

# everything else is "gray": runs in whatever dtype its inputs arrive in


def white_list():
    return set(WHITE_LIST)


def black_list():
    return set(BLACK_LIST)
