"""MoE-aware global-norm clip — port of
`paddle_tpu/incubate/distributed/models/moe/grad_clip.py` (reference
moe/grad_clip.py): the squared norms of expert and shared grads summed in
float32, every grad scaled by clip_norm / max(norm, clip_norm).  Across a
moe group of more than one rank the expert part is all-reduced first;
that waits for the port's eager `distributed/`."""
from __future__ import annotations

import torch

from .....core.tensor import Tensor
from .....nn.clip import ClipGradByGlobalNorm


class ClipGradForMOEByGlobalNorm(ClipGradByGlobalNorm):
    def __init__(self, clip_norm, is_expert_param_func=None, moe_group=None,
                 group_name="default_moe_group"):
        super().__init__(clip_norm, group_name)
        self.is_expert_fn = is_expert_param_func or (
            lambda p: getattr(p, "is_expert", False))
        self.moe_group = moe_group

    @torch.no_grad()
    def _dygraph_clip(self, params_grads):
        normal_sq, expert_sq = [], []
        for p, g in params_grads:
            if g is None:
                continue
            sq = torch.sum(torch.square(g._t.float()))
            (expert_sq if self.is_expert_fn(p) else normal_sq).append(sq)
        if not (normal_sq or expert_sq):
            return params_grads
        total_sq = sum(normal_sq) + sum(expert_sq)
        if self.moe_group is not None and self.moe_group.nranks > 1:
            raise NotImplementedError(
                "ClipGradForMOEByGlobalNorm over a moe_group of more than "
                "one rank all-reduces the expert norms, which arrives with "
                "a later slice of the port (ROADMAP Queue 1 item 13: Paddle "
                "API breadth, eager distributed/ with launch, spawn, fleet "
                "and auto_tuner)")
        global_norm = torch.sqrt(total_sq)
        scale = self.clip_norm / torch.clamp(global_norm, min=self.clip_norm)
        return [(p, g if g is None else Tensor(
            (g._t * scale).to(g._t.dtype), stop_gradient=True))
            for p, g in params_grads]
