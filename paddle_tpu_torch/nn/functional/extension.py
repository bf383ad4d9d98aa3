"""Extension functionals — port of `paddle_tpu/nn/functional/extension.py`
(reference `python/paddle/nn/functional/extension.py`).  `gather_tree`'s
`lax.scan` over time is a loop over T, from the last step back."""
from __future__ import annotations

import torch

from ...core import dtype as _dt
from ...core.tensor import apply
from ...ops.creation import diag_embed  # noqa: F401  (Paddle places it here)


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    def f(lens):
        m = maxlen if maxlen is not None else int(lens.max())
        return (torch.arange(m, device=lens.device)[None, :] <
                lens[..., None]).to(_dt.to_torch(dtype))
    return apply("sequence_mask", f, x)


def gather_tree(ids, parents):
    """ids, parents [T, B, W]: the full beams, walked back from step T - 1
    through the parent pointers."""
    def f(step_ids, parent_ids):
        T, B, W = step_ids.shape
        beams = torch.arange(W, device=step_ids.device)[None, :].expand(B, W)
        toks = []
        for t in range(T - 1, -1, -1):
            toks.append(torch.gather(step_ids[t], -1, beams))
            beams = torch.gather(parent_ids[t], -1, beams.long()).long()
        return torch.stack(toks[::-1])
    return apply("gather_tree", f, ids, parents)


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW",
                   name=None):
    def f(a):
        if data_format == "NHWC":
            a = a.permute(0, 3, 1, 2)
        nt, c, h, w = a.shape
        v = a.reshape(nt // seg_num, seg_num, c, h, w)
        fold = int(c * shift_ratio)
        left = torch.cat([v[:, 1:, :fold], torch.zeros_like(v[:, :1, :fold])],
                         1)
        right = torch.cat([torch.zeros_like(v[:, :1, fold:2 * fold]),
                           v[:, :-1, fold:2 * fold]], 1)
        out = torch.cat([left, right, v[:, :, 2 * fold:]], 2) \
            .reshape(nt, c, h, w)
        return out.permute(0, 2, 3, 1) if data_format == "NHWC" else out
    return apply("temporal_shift", f, x)
