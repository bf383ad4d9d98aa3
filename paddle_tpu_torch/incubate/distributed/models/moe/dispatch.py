"""Capacity-routed MoE FFN (expert-parallel degree 1) — the port's copy of
`paddle_tpu/incubate/distributed/models/moe/dispatch.py`.

Plain torch, as the reference is plain jnp (no Pallas kernel).  Each
(token, k) routing gets a unique slot `expert * C + arrival position` in
its expert's queue from one cumsum over a `[T * k, E]` one-hot, counted
row-major over `[T, k]`; assignments past the capacity C are dropped.
Everything has a static shape (C is a Python int of the row count) and
nothing reads a device value on the host, so a serving step that runs it
captures as one CUDA graph:

- the gate logits and softmax are float32 whatever the activations' dtype
  (jnp promotes `bf16 @ f32`; torch needs the cast);
- top-k breaks ties toward the lower expert index, as `lax.top_k` does: a
  stable descending sort, where `torch.topk`'s order under ties is
  unspecified;
- a dropped assignment's slot is E * C, a spare row of the dispatch buffer
  that is sliced off (the reference's scatter `mode="drop"`).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F


def moe_capacity(num_tokens: int, topk: int, num_experts: int,
                 capacity_factor: float) -> int:
    """Static per-expert queue length (at least 4)."""
    return max(int(math.ceil(capacity_factor * num_tokens * topk /
                             num_experts)), 4)


def _one_hot(idx, n):
    """[..., n] int32 one-hot without `F.one_hot`'s range checks."""
    return (idx[..., None] == torch.arange(n, device=idx.device)) \
        .to(torch.int32)


# this process's log of `route`'s choices while `log_routes` holds it open
_ROUTE_LOG: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None


def log_routes(on: bool, mesh=None):
    """Open (`on`) or close this process's log of the router's choices and
    return what the log held: one (probs [T, E], gate_idx [T, k]) on the
    CPU per `route` call, in call order (None if no log was open).  It
    reads device values, so nothing that a CUDA graph captures runs while
    it is open.  `mesh=`: a mesh's `run` calls it on every rank."""
    global _ROUTE_LOG
    out, _ROUTE_LOG = _ROUTE_LOG, ([] if on else None)
    return out


def route(logits, topk: int, normalize: bool = True):
    """The softmax-top-k router's choices: (probs [T, E] float32, gate_idx
    [T, k] int32, gate_val [T, k] float32)."""
    probs = torch.softmax(logits.float(), dim=-1)                 # [T, E]
    order = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    gate_idx = order[:, :topk]
    gate_val = torch.gather(probs, -1, gate_idx)
    if normalize and topk > 1:
        gate_val = gate_val / torch.clamp(gate_val.sum(-1, keepdim=True),
                                          min=1e-9)
    gate_idx = gate_idx.to(torch.int32)
    if _ROUTE_LOG is not None:
        _ROUTE_LOG.append((probs.detach().cpu(), gate_idx.cpu()))
    return probs, gate_idx, gate_val


def topk_gating(logits, topk: int, normalize: bool = True):
    """Softmax-top-k router.  Returns (gate_idx [T, k] int32, gate_val
    [T, k] float32, aux): aux is the Switch load-balance loss
    E * sum_e(fraction of first choices on e * mean probability of e)."""
    probs, gate_idx, gate_val = route(logits, topk, normalize)
    E = logits.shape[-1]
    me = probs.mean(0)
    ce = _one_hot(gate_idx[:, 0], E).float().mean(0)
    aux = E * torch.sum(me * ce)
    return gate_idx, gate_val, aux


def expert_counts(gate_idx, num_experts: int):
    """[E] int32: the (token, k) routings each expert receives."""
    return _one_hot(gate_idx.reshape(-1), num_experts).sum(0)


def capacity_slots(gate_idx, num_experts: int, capacity: int, offset=None):
    """Each (token, k) routing's slot in its expert's queue, in arrival
    order.  Returns (slot [T, k] int64 in [0, E * C]: E * C means dropped,
    keep [T, k] bool).  `offset` [E]: the routings each queue already
    holds from tokens ahead of these (another rank's rows of one routing
    group)."""
    T, k = gate_idx.shape
    E, C = num_experts, capacity
    onehot = _one_hot(gate_idx.reshape(T * k), E)
    pos = torch.cumsum(onehot, dim=0)
    if offset is not None:
        pos = pos + offset.to(pos.dtype)
    pos = (pos * onehot).sum(-1).reshape(T, k) - 1
    keep = pos < C
    slot = torch.where(keep, gate_idx.long() * C + pos, E * C)
    return slot, keep


def dispatch(x, slot, num_experts: int, capacity: int):
    """x [T, D] -> expert buffers [E, C, D].  Slots are unique but for the
    dropped ones, which land on the spare row E * C."""
    T, D = x.shape
    k = slot.shape[1]
    EC = num_experts * capacity
    xk = x[:, None, :].expand(T, k, D).reshape(T * k, D)
    buf = torch.index_copy(x.new_zeros((EC + 1, D)), 0, slot.reshape(T * k),
                           xk)
    return buf[:EC].reshape(num_experts, capacity, D)


def combine(expert_out, slot, keep, gate_val):
    """Expert buffers [E, C, D] -> [T, D], each assignment weighted by its
    gate value; a dropped one adds zero (the caller's residual carries the
    token)."""
    E, C, D = expert_out.shape
    T, k = slot.shape
    flat = expert_out.reshape(E * C, D)
    picked = flat[torch.clamp(slot, 0, E * C - 1).reshape(T * k)] \
        .reshape(T, k, D)
    w = (gate_val * keep.to(gate_val.dtype)).to(picked.dtype)
    return torch.einsum("tk,tkd->td", w, picked)


def _activate(h, activation):
    if activation == "gelu":
        return F.gelu(h, approximate="tanh")    # jax.nn.gelu's default
    return F.silu(h)


def expert_ffn(buf, fc1_w, fc1_b, fc2_w, fc2_b, activation: str = "gelu"):
    """Batched per-expert MLP: buf [E, C, D] x fc1_w [E, D, F] -> [E, C, D]
    (two batched GEMMs)."""
    h = torch.matmul(buf, fc1_w) + fc1_b[:, None, :]
    h = _activate(h, activation)
    return torch.matmul(h, fc2_w) + fc2_b[:, None, :]


def moe_ffn_dense(bp, x, config):
    """Single-group MoE FFN: x [T, D] -> ([T, D], aux).  bp holds one
    block's `gate_w [D, E]` (float32), `exp_fc1_w [E, D, F]`, `exp_fc1_b
    [E, F]`, `exp_fc2_w [E, F, D]`, `exp_fc2_b [E, D]`."""
    E = config.moe_num_experts
    k = config.moe_topk
    T = x.shape[0]
    C = moe_capacity(T, k, E, config.moe_capacity_factor)
    logits = torch.matmul(x.to(bp["gate_w"].dtype), bp["gate_w"])
    gate_idx, gate_val, aux = topk_gating(logits, k)
    slot, keep = capacity_slots(gate_idx, E, C)
    buf = dispatch(x, slot, E, C)
    out = expert_ffn(buf, bp["exp_fc1_w"], bp["exp_fc1_b"],
                     bp["exp_fc2_w"], bp["exp_fc2_b"], config.activation)
    return combine(out, slot, keep, gate_val), aux
