"""Pipeline-parallel training over send/recv — the port of the reference's
`_pp_loss` (`paddle_tpu/parallel/hybrid.py`).

A rank of a pp mesh holds the layers of its stage (`hybrid.stage_layers`
under vpp: chunk c of stage p is layers (c * pp + p) * Lc .. + Lc, held
chunk-major; else the contiguous L / pp).  Each rank runs the same
sequence of work units, (chunk, microbatch) pairs (`units`): for vpp 1
microbatch m at step m (the reference's tick m + p on stage p); for vpp >
1 the reference's closed form (position u: group g = u // (vpp * pp),
chunk c = u % (vpp * pp) // pp, microbatch g * pp + u % pp), which is the
order its tick table gives each stage.  A unit's input is the embedding
(stage 0, chunk 0: the vocab-parallel lookup, `wpe` when rope is off), or
the boundary activation received from the previous stage (from the last
stage for stage 0's later chunks); its output goes to the next stage, or
on the last stage's last chunk through `lnf`, the head and the
vocab-parallel cross entropy.  A stage computes the head itself, where the
reference spreads the head's rows over pp (`_vp_ce`): the loss is the
same.

The forward runs every unit, keeping each unit's graph; the backward
then runs the units newest first, as `jax.grad` of the reference's scan
does: a unit's output gradient is received from the next stage (or is the
loss's), its input gradient sent back.  Parameter gradients accumulate in
`.grad` across the microbatches.  A 1F1B order that keeps fewer
microbatches alive is a speed item (ROADMAP Queue 2).

Sends are started and waited for at the end of each pass; receives block.
The units' order is one that every dependency respects on every stage,
so a stage never waits on a stage that waits on it.  Each directed link
between neighbouring stages is a process group of its own ("pp_next" /
"pp_prev"), apart from the "pp" axis group over the same ranks at pp 2,
so that under NCCL one link's send never queues behind another's receive
or behind a collective.

Every microbatch term is `loss_sum_m / n`, n the count of valid labels
over all microbatches and data ranks, reduced before the forward starts.
The MoE penalty is summed over the units and divided by M (the
reference's `aux_sum / M`); a stage's blocks count their own.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..models import gpt as gpt_mod


def units(pp: int, vpp: int, M: int) -> List[Tuple[int, int]]:
    """The (chunk, microbatch) units every stage runs, in order."""
    if vpp == 1:
        return [(0, m) for m in range(M)]
    if M % pp:              # eval's one microbatch: chunk after chunk
        return [(c, m) for c in range(vpp) for m in range(M)]
    out = []
    for u in range(vpp * M):
        g, r = divmod(u, vpp * pp)
        out.append((r // pp, g * pp + r % pp))
    return out


def bubble_share(pp: int, vpp: int, M: int) -> float:
    """The idle share of a stage in the reference's tick schedule:
    (pp - 1) of the vpp * M + pp - 1 ticks."""
    return (pp - 1) / (vpp * M + pp - 1)


class _Stage:
    """One rank's stage: its chunks, links and the shapes it exchanges."""

    def __init__(self, rt, tokens):
        cfg, config = rt.cfg, rt.config
        self.view, self.groups = rt.view, rt.groups
        self.p, self.pp, self.vpp = rt.coords["pp"], cfg.pp, cfg.vpp
        blocks = rt.params["blocks"]
        n = next(iter(blocks.values())).shape[0]
        Lc = n // self.vpp
        self.chunks = [{k: v.narrow(0, c * Lc, Lc) for k, v in blocks.items()}
                       for c in range(self.vpp)] if self.vpp > 1 else [blocks]
        M, b, S = tokens.shape
        if self.view.sequence_parallel:
            S //= cfg.mp
        self.shape = (b, S, config.hidden_size)
        self.dtype = config.dtype
        self.M = M

    def first(self, c):
        return self.p == 0 and c == 0

    def last(self, c):
        return self.p == self.pp - 1 and c == self.vpp - 1

    def receive(self, link):
        g = self.groups[link]
        return g.recv(self.shape, self.dtype, 1 - g.rank)

    def send(self, link, t):
        g = self.groups[link]
        return g.isend(t, 1 - g.rank)


def _forward(rt, tokens, labels, n, grad: bool):
    """Every unit of this stage: [(input leaf or None, output or the loss
    term, the MoE penalty or None)], and the stage's loss and penalty
    sums (detached)."""
    st = _Stage(rt, tokens)
    config, view = rt.config, st.view
    head = gpt_mod.head_matrix(rt.params, config)
    moe = config.moe_num_experts > 0
    kept, sends = [], []
    ce = pen_sum = 0.0
    for c, m in units(st.pp, st.vpp, st.M):
        x_in = None
        with torch.set_grad_enabled(grad), view.saving():
            if st.first(c):
                x = gpt_mod.embed(rt.params, tokens[m], config, mesh=view)
            else:
                x = x_in = st.receive("pp_prev").requires_grad_(grad)
            y, aux = gpt_mod.run_blocks(st.chunks[c], x, config,
                                        remat=rt.cfg.remat and grad,
                                        mesh=view)
            pen = config.moe_aux_weight * aux / st.M if moe else None
            if st.last(c):
                h = gpt_mod.epilogue(rt.params, y, config)
                ls, _ = gpt_mod.ce_sums(h, head, labels[m], mesh=view)
                y = ls / n
                ce = ce + y.detach()
            else:
                sends.append(st.send("pp_next", y))
        if pen is not None:
            pen_sum = pen_sum + pen.detach()
        kept.append((x_in, y, pen))
    for s in sends:
        s.wait()
    return st, kept, ce, (pen_sum if moe else None)


def _label_count(rt, labels):
    n = (labels >= 0).sum().to(torch.float32)
    return torch.clamp(rt.groups["data"].all_reduce(n), min=1.0)


def _reported(rt, ce, pen):
    """The step's loss on every rank: the last stage's terms and every
    stage's MoE penalty, summed over the data group and pp."""
    group = rt.groups["data_pp"]
    loss = torch.as_tensor(ce, dtype=torch.float32, device=rt.device)
    return group.all_reduce(loss.clone()) + rt.view.penalty_share(pen, group)


def train_grads(rt, leaves, tokens, labels):
    """One rank's pipeline step: tokens, labels [M, rows, S] (its rows of
    each microbatch) -> (the step's loss, the gradients of `leaves`, the
    rank's parameters, before any reduction)."""
    for p in leaves:
        p.grad = None
    n = _label_count(rt, labels)
    st, kept, ce, pen = _forward(rt, tokens, labels, n, grad=True)
    sends = []
    for c, _ in reversed(units(st.pp, st.vpp, st.M)):
        x_in, y, pen_u = kept.pop()         # its graph goes after this
        outs, grads = [y], [None]
        if not st.last(c):
            grads = [st.receive("pp_next")]
        if pen_u is not None:
            outs.append(pen_u)
            grads.append(None)
        torch.autograd.backward(outs, grads)
        if x_in is not None:
            sends.append(st.send("pp_prev", x_in.grad))
    for s in sends:
        s.wait()
    grads = []
    for p in leaves:
        grads.append(p.grad if p.grad is not None else torch.zeros_like(p))
        p.grad = None
    return _reported(rt, ce, pen), grads


def eval_loss(rt, tokens, labels):
    """The loss of the rank's rows [1, rows, S] through the stages, forward
    only; MoE routes the whole batch as one group."""
    rt.view.evaluating = True
    try:
        with torch.no_grad():
            n = _label_count(rt, labels)
            _, _, ce, pen = _forward(rt, tokens, labels, n, grad=False)
            return _reported(rt, ce, pen)
    finally:
        rt.view.evaluating = False
