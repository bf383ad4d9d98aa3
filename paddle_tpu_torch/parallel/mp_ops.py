"""Autograd-aware collectives of Megatron tensor and sequence parallelism —
the port's counterpart of the reference Paddle's `fleet/layers/mpu/mp_ops.py`
(`paddle_tpu/distributed/fleet/layers/mpu.py` in the JAX package).

Each is a `torch.autograd.Function` over a `parallel.tp.Group` (the "mp"
axis of a training mesh):

- `copy_to_mp`: identity forward, all-reduce backward — the input of a
  column-parallel matmul whose rows every rank holds (`_c_identity`);
- `reduce_from_mp`: all-reduce forward, identity backward — a row-parallel
  matmul's partial sums (`_mp_allreduce`);
- `gather_from_sp`: all-gather along the sequence axis forward,
  reduce-scatter backward — the input of a column-parallel matmul under
  sequence parallelism, where each rank holds S/mp rows;
- `scatter_to_sp`: reduce-scatter along the sequence axis forward,
  all-gather backward — a row-parallel output under sequence parallelism;
- `vocab_parallel_ce`: the sums of a cross entropy whose logits each rank
  holds for its vocab columns (the reference's `_vp_ce`, `ParallelCrossEntropy`):
  a max over mp, a sum of exps over mp, the label's logit from the rank
  that owns it; backward softmax minus one-hot on the local columns.

And the two per-layer gathers of ZeRO-3 over the "sharding" axis:
`broadcast_layer` (a whole layer from the rank that owns it; backward the
gradient summed over the group, kept by the owner) and `gather_dim` (a
layer split along another dimension; backward reduce-scatter).

Collectives never modify a tensor autograd may hold: the in-place ones run
on copies.
"""
from __future__ import annotations

import torch

SEQ = 1     # the sequence axis of [B, S, D] activations


class _CopyToMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous().clone()), None


class _ReduceFromMp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromSp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_gather(x, SEQ)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce_scatter(g, SEQ), None


class _ScatterToSp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.reduce_scatter(x, SEQ)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g, SEQ), None


def copy_to_mp(x, group):
    return x if group.size == 1 else _CopyToMp.apply(x, group)


def reduce_from_mp(x, group):
    return x if group.size == 1 else _ReduceFromMp.apply(x, group)


def gather_from_sp(x, group):
    return x if group.size == 1 else _GatherFromSp.apply(x, group)


def scatter_to_sp(x, group):
    return x if group.size == 1 else _ScatterToSp.apply(x, group)


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, group, start):
        lg = logits.float()
        mx = group.all_reduce(lg.amax(-1), "max")
        se = group.all_reduce(torch.exp(lg - mx[..., None]).sum(-1))
        lse = mx + torch.log(se)
        ids = labels - start
        own = (ids >= 0) & (ids < lg.shape[-1])
        safe = ids.clamp(0, lg.shape[-1] - 1)
        pick = torch.gather(lg, -1, safe[..., None])[..., 0]
        pick = group.all_reduce(torch.where(own, pick, 0.0))
        mask = labels >= 0
        loss_sum = ((lse - pick) * mask).sum()
        n = mask.sum().float()
        ctx.group = group
        ctx.save_for_backward(logits, lse, safe, own & mask, mask)
        ctx.mark_non_differentiable(n)
        return loss_sum, n

    @staticmethod
    def backward(ctx, g, _):
        logits, lse, safe, hit, mask = ctx.saved_tensors
        p = torch.exp(logits.float() - lse[..., None]) * mask[..., None]
        p.scatter_add_(-1, safe[..., None], -hit[..., None].float())
        return (p * g).to(logits.dtype), None, None, None


def vocab_parallel_ce(logits, labels, group, start: int):
    """(-sum log p[label], count) over the valid labels (-100 = ignore) of
    `logits` [.., V/mp], this rank's vocab columns `start..`: the same sums
    on every rank of `group`."""
    return _VocabParallelCE.apply(logits, labels, group, start)


class _BroadcastLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, group, owner, shape, dtype):
        ctx.group, ctx.owner = group, owner
        return broadcast_raw(src, group, owner, shape, dtype)

    @staticmethod
    def backward(ctx, g):
        g = ctx.group.all_reduce(g.contiguous().clone())
        if ctx.group.rank != ctx.owner:
            g = g.new_empty(0)          # the anchor's
        return g, None, None, None, None


def broadcast_raw(src, group, owner, shape, dtype):
    """The owner's layer `src` on every member (`src` on the others: any
    tensor on the device), outside autograd."""
    if group.rank == owner:
        buf = src.detach().contiguous().clone()
    else:
        buf = torch.empty(shape, dtype=dtype, device=src.device)
    return group.broadcast(buf, owner)


def broadcast_layer(src, group, owner: int, shape, dtype):
    """A ZeRO-3 layer leaf of full `shape` from member `owner`, whose
    `src` it is; the other members pass a 0-element anchor that requires a
    gradient, so that every member runs the backward's collective."""
    return _BroadcastLayer.apply(src, group, owner, tuple(shape), dtype)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(src, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce_scatter(g, ctx.dim), None, None


def gather_dim(src, group, dim: int):
    """A ZeRO-3 layer leaf whose members each hold a part along `dim`."""
    return _GatherDim.apply(src, group, dim)
