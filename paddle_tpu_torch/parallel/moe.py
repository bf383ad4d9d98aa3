"""Expert-parallel MoE on a training mesh — the port of the reference's
`_moe_local` and `_moe_ffn_ep` (`paddle_tpu/parallel/hybrid.py`), over the
dispatch functions of `incubate.distributed.models.moe.dispatch`.

A routing group is the set of tokens whose queues are counted together:
capacity C comes from the group's token count, and a (token, k) routing's
queue position counts every earlier routing of the group, token-major,
then by k.  The reference's groups are those of its programs, not of the
devices: under ep > 1 `_moe_ffn_ep` hands `shard_map` the flattened global
`[B * S, D]` with `P("ep")`, so ep group g routes the contiguous g-th
1/ep of the step's tokens (of a microbatch's under pp); at ep 1 one group
holds them all.  A rank of the port holds the rows the data split gives
it, so a group may span several ranks (`route`, the ranks of the group in
token order): each rank routes its own tokens, and its queue positions
start after the earlier ranks' routings to the same expert (an
all-gather of the per-expert counts).

Each rank dispatches into the group's [E, C, D] buffers, the tiled
all-to-all over "ep" (`mp_ops.all_to_all`) brings each rank's E/ep
experts their queue slices from its ep peers, the batched expert FFN runs
there (its products `torch.matmul`, as the reference leaves them to XLA),
and the reverse all-to-all brings the outputs back for the combine.  The
expert FFN is row by row, so a rank's buffer holds only its own tokens,
at the group's positions.  Under n = dp x sharding > 1 the buffers, the
all-to-all and the expert FFN so carry the group's C rows a queue, of
which the rank fills about 1/n: n times the rows it routes (ROADMAP Queue
2 item 16).

The load-balance loss is the group's: E * sum(me * ce) over the group's
mean router probabilities (summed over `route` forward, the backward the
identity, so each rank's gradient is its own tokens' share) and its
first-choice fractions.
"""
from __future__ import annotations

import torch

from ..incubate.distributed.models.moe.dispatch import (capacity_slots,
                                                        combine, dispatch,
                                                        expert_counts,
                                                        expert_ffn,
                                                        moe_capacity, route)
from . import mp_ops

EXPERT_KEYS = ("exp_fc1_w", "exp_fc1_b", "exp_fc2_w", "exp_fc2_b")


def moe_local(bp, x, config, route_group=None, ep_group=None):
    """x [T, D], this rank's tokens of a routing group spread over
    `route_group` (None: the group is x) -> (y [T, D], the group's aux).
    bp holds one block's `gate_w` [D, E] and this rank's E/ep experts
    (`exp_fc1_w` [E/ep, D, F], ...); `ep_group`: the ranks that own the
    other experts (None or size 1: all of them here)."""
    E, k = config.moe_num_experts, config.moe_topk
    n = route_group.size if route_group is not None else 1
    ep = ep_group.size if ep_group is not None else 1
    if E % ep:
        raise AssertionError(f"experts {E} must divide over ep={ep}")
    T = x.shape[0]
    C = moe_capacity(T * n, k, E, config.moe_capacity_factor)
    probs, gate_idx, gate_val = route(
        torch.matmul(x.to(bp["gate_w"].dtype), bp["gate_w"]), k)
    offset = None
    if n > 1:
        every = route_group.all_gather(expert_counts(gate_idx, E)[None], 0)
        offset = every[:route_group.rank].sum(0)
    slot, keep = capacity_slots(gate_idx, E, C, offset)
    buf = dispatch(x, slot, E, C)                       # [E, C, D]
    if ep > 1:
        buf = mp_ops.all_to_all(buf, ep_group, 0, 1)    # [E/ep, ep * C, D]
    out = expert_ffn(buf, bp["exp_fc1_w"], bp["exp_fc1_b"], bp["exp_fc2_w"],
                     bp["exp_fc2_b"], config.activation)
    if ep > 1:
        out = mp_ops.all_to_all(out, ep_group, 1, 0)    # [E, C, D]
    y = combine(out, slot, keep, gate_val)
    me = probs.sum(0)
    ce = expert_counts(gate_idx[:, :1], E).float()
    if n > 1:
        me = mp_ops.reduce_from_mp(me, route_group)
        ce = route_group.all_reduce(ce)
    aux = E * torch.sum((me / (T * n)) * (ce / (T * n)))
    return y, aux
