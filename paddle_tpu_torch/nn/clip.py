"""Gradient clipping — port of `paddle_tpu/nn/clip.py` (reference
`python/paddle/nn/clip.py`: ClipGradByValue, ClipGradByNorm,
ClipGradByGlobalNorm).  Each takes [(param, grad)] and returns new
stop-gradient grads, computed outside the tape."""
from __future__ import annotations

import torch

from ..core.tensor import Tensor


def _grad(g):
    return Tensor(g, stop_gradient=True)


class ClipGradBase:
    def __call__(self, params_grads):
        return self._dygraph_clip(params_grads)

    def _dygraph_clip(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    @torch.no_grad()
    def _dygraph_clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None or getattr(p, "_need_clip", True) is False:
                out.append((p, g))
                continue
            out.append((p, _grad(torch.clamp(g._t, self.min, self.max))))
        return out


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @torch.no_grad()
    def _dygraph_clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if g is None:
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(g._t.float() ** 2))
            scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                                max=1.0)
            out.append((p, _grad((g._t * scale).to(g._t.dtype))))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Global-norm clip over every grad that may be clipped."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        self.group_name = group_name

    @torch.no_grad()
    def _dygraph_clip(self, params_grads):
        sq = [torch.sum(g._t.float() ** 2) for p, g in params_grads
              if g is not None and getattr(p, "_need_clip", True) is not False]
        if not sq:
            return params_grads
        global_norm = self._reduce_global_norm_sq(torch.sqrt(sum(sq)))
        scale = self.clip_norm / torch.clamp(global_norm, min=self.clip_norm)
        out = []
        for p, g in params_grads:
            if g is None or getattr(p, "_need_clip", True) is False:
                out.append((p, g))
                continue
            out.append((p, _grad((g._t * scale).to(g._t.dtype))))
        return out

    def _reduce_global_norm_sq(self, global_norm):
        # the hook a hybrid-parallel wrapper overrides to reduce across groups
        return global_norm


GradientClipBase = ClipGradBase
GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm
