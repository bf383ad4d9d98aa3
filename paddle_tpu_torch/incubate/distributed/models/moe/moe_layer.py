"""MoELayer — port of
`paddle_tpu/incubate/distributed/models/moe/moe_layer.py` (reference
`incubate/distributed/models/moe/moe_layer.py`).

Capacity routing at expert-parallel degree 1 through the port's
`dispatch.py` (`capacity_slots`, `dispatch`, `combine`): each (token, k)
assignment takes the next slot of its expert's queue of C =
max(int(capacity_factor * T * topk / E), 4); those past C are dropped and
add zero.  The slots are integers, computed once from the gate's indices
and closed over by the two tape ops, "moe_scatter" and "moe_gather".
"""
from __future__ import annotations

from .....core.tensor import Tensor, apply
from .....nn.layer.layers import Layer
from .dispatch import capacity_slots, combine, dispatch
from .gate import GShardGate, NaiveGate, SwitchGate


def _raw(x):
    return x._t if isinstance(x, Tensor) else x


def dispatch_and_combine(x, gate_idx, gate_val, experts_fn, num_expert,
                         capacity):
    """x [T, D]; gate_idx, gate_val [T, k]; experts_fn maps the expert
    buffers [E, C, D] to [E, C, D].  Returns [T, D]."""
    slot, keep = capacity_slots(_raw(gate_idx), num_expert, capacity)
    expert_in = dispatch(_raw(x), slot, num_expert, capacity)
    expert_out = experts_fn(expert_in)
    return combine(expert_out, slot, keep, _raw(gate_val).float())


class MoELayer(Layer):
    """A gate, the experts (Layers mapping [*, D] to [*, D]) and the
    capacity dispatch."""

    def __init__(self, d_model, experts=None, gate=None, moe_group=None,
                 mp_group=None, recompute_interval=0, capacity_factor=1.2,
                 topk=2, **kwargs):
        super().__init__()
        from .....nn.layer.container import LayerList
        self.d_model = d_model
        self.experts = experts if isinstance(experts, LayerList) \
            else LayerList(experts)
        self.num_expert = len(self.experts)
        self.capacity_factor = capacity_factor
        if gate is None or gate == "naive":
            gate = NaiveGate(d_model, self.num_expert, topk=topk)
        elif gate == "gshard":
            gate = GShardGate(d_model, self.num_expert, topk=topk)
        elif gate == "switch":
            gate = SwitchGate(d_model, self.num_expert)
        self.gate = gate

    def forward(self, x):
        orig_shape = x.shape
        x2 = x.reshape([-1, self.d_model])
        T = x2.shape[0]
        gate_idx, gate_val = self.gate(x2)
        C = max(int(self.capacity_factor * T * self.gate.topk /
                    self.num_expert), 4)
        return self._forward_eager(x2, gate_idx, gate_val, C) \
            .reshape(orig_shape)

    def _forward_eager(self, x2, gate_idx, gate_val, C):
        from .....ops.manipulation import stack
        E = self.num_expert
        slot, keep = capacity_slots(_raw(gate_idx).detach(), E, C)
        expert_in = apply("moe_scatter", lambda xx: dispatch(xx, slot, E, C),
                          x2)
        expert_out = stack([expert(expert_in[e])
                            for e, expert in enumerate(self.experts)], axis=0)
        return apply("moe_gather",
                     lambda val, eo: combine(eo, slot, keep, val.float()),
                     gate_val, expert_out)
