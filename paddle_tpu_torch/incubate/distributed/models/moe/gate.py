"""MoE gates — port of `paddle_tpu/incubate/distributed/models/moe/gate.py`
(reference `incubate/distributed/models/moe/gate/`: naive, gshard,
switch).  `gate_weight` [d_model, E] is `XavierNormal`; top-k is the
port's `ops.search.topk` (ties to the lower expert); the switch gate's
training noise is `ops.random.uniform` from the port's generator; the aux
losses are `apply` ops, E * sum_e(mean probability of e * share of first
choices on e)."""
from __future__ import annotations

import torch

from .....core.tensor import apply
from .....nn import functional as F
from .....nn.initializer import XavierNormal
from .....nn.layer.layers import Layer


def _aux(E):
    def aux(p, top1):
        me = p.mean(0)
        ce = (top1.long()[:, None] == torch.arange(E, device=p.device)) \
            .float().mean(0)
        return torch.sum(me * ce) * E
    return aux


class BaseGate(Layer):
    def __init__(self, d_model, num_expert, world_size=1, topk=2):
        super().__init__()
        self.d_model = d_model
        self.num_expert = num_expert
        self.world_size = world_size
        self.tot_expert = num_expert * world_size
        self.topk = topk
        self.loss = None

    def get_loss(self, clear=True):
        loss = self.loss
        if clear:
            self.loss = None
        return loss


class NaiveGate(BaseGate):
    def __init__(self, d_model, num_expert, world_size=1, topk=2):
        super().__init__(d_model, num_expert, world_size, topk)
        self.gate_weight = self.create_parameter(
            [d_model, self.tot_expert], default_initializer=XavierNormal())

    def forward(self, inp):
        from .....ops.search import topk as _topk
        logits = inp.matmul(self.gate_weight)
        vals, idx = _topk(logits, self.topk, axis=-1)
        return idx, F.softmax(vals, axis=-1)


class GShardGate(NaiveGate):
    """Top-k gate with the load-balancing aux loss (reference
    gshard_gate.py)."""

    def __init__(self, d_model, num_expert, world_size=1, topk=2,
                 capacity=(1.2, 2.4), random_routing=True, group=None):
        super().__init__(d_model, num_expert, world_size, topk)
        self.capacity = capacity

    def forward(self, inp):
        from .....ops.search import topk as _topk
        logits = inp.matmul(self.gate_weight)
        probs = F.softmax(logits, axis=-1)
        vals, idx = _topk(probs, self.topk, axis=-1)
        self.loss = apply("gshard_aux_loss", _aux(self.tot_expert), probs,
                          idx[:, 0])
        denom = vals.sum(axis=-1, keepdim=True)
        return idx, vals / denom


class SwitchGate(BaseGate):
    """Top-1 switch gate (reference switch_gate.py)."""

    def __init__(self, d_model, num_expert, world_size=1, topk=1,
                 switch_eps=0.1, capacity=(1.2, 2.4), group=None):
        super().__init__(d_model, num_expert, world_size, 1)
        self.switch_eps = switch_eps
        self.gate_weight = self.create_parameter(
            [d_model, self.tot_expert], default_initializer=XavierNormal())

    def forward(self, inp):
        from .....ops.search import topk as _topk
        logits = inp.matmul(self.gate_weight)
        if self.training and self.switch_eps > 0:
            from .....ops.random import uniform
            noise = uniform(logits.shape, min=1.0 - self.switch_eps,
                            max=1.0 + self.switch_eps)
            logits = logits * noise
        probs = F.softmax(logits, axis=-1)
        vals, idx = _topk(probs, 1, axis=-1)
        self.loss = apply("switch_aux_loss", _aux(self.tot_expert), probs,
                          idx[:, 0])
        return idx, vals
