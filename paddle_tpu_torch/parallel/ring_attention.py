"""Ring attention (context parallelism) — port of
`paddle_tpu/parallel/ring_attention.py`.

The sequence is sharded over the cp ranks of a ring, in rank order: rank
c holds positions [c * Sl, (c + 1) * Sl) of q, k and v.  q stays where it
is; the k/v chunks travel one hop a step around the ring (rank c sends to
c + 1, the last rank to rank 0), so at step t rank c holds the chunk of
rank (c - t) % cp, and folds it into its rows' softmax.  Causal masking is
by global position (`qpos >= kpos`).

Two routes compute a rank's share:

- `ring_attention_local`, the plain version: the reference's blockwise
  math in float32 (scores, running max, sum and output over the chunks),
  with the ring's hops as autograd-aware shifts (`_Shift`: forward to the
  next rank, backward to the previous one), so autograd gives the ring
  backward the reference gets from `jax.grad` of its scan.  It is the CPU
  path and the oracle.
- `RingFlashAttention`, the card path: each chunk is the work of the
  port's dense flash kernels (`incubate/kernels/flash_attention.py`, the
  ports of `_flash_fwd_kernel`, `_flash_bwd_dkv_kernel` and
  `_flash_bwd_dq_kernel`): the chunk on the diagonal (t = 0) causal with
  S == Sk, an earlier rank's chunk non-causal, a later rank's skipped
  under causal masking.  The forward merges the chunks' partial outputs by
  their lse, in float32, into the output and the global lse.  The
  backward computes delta = rowsum(dO * O) once, runs the dq and dkv
  kernels on every visible chunk against the global lse, and sends each
  chunk's dK/dV accumulator back around the ring (rank c to c - 1), so
  that it ends at its owner: the transpose of the forward's hops.  The
  chunks are saved from the forward (the reference's scan keeps its
  carries), so the backward moves only the accumulators.

The chunks travel with their kv heads (KVH of a grouped-query model, the
rank's KVH / mp under tensor parallelism) and are widened to q's heads on
the rank (`repeat_interleave`, as `models.gpt` widens them); the
accumulators travel narrowed the same way.  Widening before sending would
move H / KVH times the bytes.

`ring_attend` picks the route: CPU tensors the plain version; CUDA tensors
the kernels where they take the shapes (`kernel_takes`), else the plain
version, counted in `flash_attention_fused.composed_calls` as the model's
other attention routes count theirs.

Point-to-point traffic, per rank and per call (`RingLink`: one process
group over the ring's cp ranks, "cp_ring", apart from every collective
group and connected as it is made; each hop one send and one receive
issued together, one coalesced NCCL call; host-staged under gloo on CUDA,
counted as "<direction>.send_host"/"recv_host"), counted by direction:

    forward:  cp - 1 sends to rank + 1 ("cp_next.send"), each the k/v
              chunk [2, B, Sl, KVH, hd] in k's dtype (2 * B * Sl * KVH *
              hd * itemsize bytes), and cp - 1 receives from rank - 1
              ("cp_prev.recv");
    backward: cp - 1 sends to rank - 1 ("cp_prev.send") of the dK/dV
              accumulator of the same shape and dtype, and cp - 1
              receives from rank + 1 ("cp_next.recv").

Under NCCL a ring of sends and receives on separate communicators can
wait on itself (NCCL does not promise to progress two communicators'
kernels together); paired on one communicator, each hop's send and
receive start in one group call on every rank.

So a training step of a rank sends layers (of its stage) x microbatches x
2 (cp - 1) times, half in each direction; remat replays a block's qkv and tail
but keeps the ring's output and never runs the ring again; `eval_loss`
sends layers x (cp - 1).  On the kernel route rank c launches the forward,
dkv and dq kernels once for each chunk it sees: c + 1 times a call under
causal masking (cp without), so a training step's launches of each are
layers x microbatches x (c + 1) on rank c.

`ring_attention(q, k, v, mesh, causal=True)` is the reference's entry: the
full sequence on the caller's process, split over the ranks of a
`parallel.tp` mesh, differentiable (the ranks keep their graphs between
the forward and the backward).
"""
from __future__ import annotations

import itertools
import math
from typing import List, Optional

import torch

from ..incubate.kernels import flash_attention as FA

NEG_INF = -1e30


class RingLink:
    """A rank's place on a ring of `size` ranks: its index `rank`, and the
    ring's one process group over its cp ranks (`group`, "cp_ring", in
    ring order, its NCCL communicator connected as it is made).  A hop
    sends to one neighbour and receives from the other as one pair
    (`MeshRank.exchange`: one coalesced NCCL call), counted by direction:
    a forward hop as "cp_next.send" and "cp_prev.recv", a backward hop as
    "cp_prev.send" and "cp_next.recv"."""

    def __init__(self, group, rank: int, size: int):
        self.group, self.rank, self.size = group, rank, size

    @classmethod
    def of(cls, groups, rank: int, size: int) -> Optional["RingLink"]:
        """The ring of `groups["cp_ring"]` (None at size 1)."""
        if size == 1:
            return None
        g = groups["cp_ring"]
        if g.rank != rank:
            raise ValueError(f"ring rank {rank} is member {g.rank} of "
                             f"{g.ranks}")
        return cls(g, rank, size)

    def forward_hop(self, t):
        """Start sending `t` to rank + 1 and receiving rank - 1's; the
        handle's `wait()` gives the received tensor."""
        n, c = self.size, self.rank
        return self.group.exchange(t, (c + 1) % n, (c - 1) % n,
                                   ("cp_next", "cp_prev"))

    def backward_hop(self, t):
        """The reverse: `t` to rank - 1, rank + 1's received."""
        n, c = self.size, self.rank
        return self.group.exchange(t, (c - 1) % n, (c + 1) % n,
                                   ("cp_prev", "cp_next"))

    def attend(self, q, k, v, causal=True, scale=None):
        """This rank's share of ring attention (`ring_attend`)."""
        return ring_attend(q, k, v, self, causal, scale)


def ring_group(handle, ranks) -> dict:
    """{"cp_ring": the group of `handle`'s rank over the ring of `ranks`
    (mesh ranks in ring order)}: a process group of its own, apart from
    every collective group, connected as it is made."""
    return {"cp_ring": handle.group("cp_ring", ranks, link=True,
                                    connect=True)}


def _widen(t, heads: int):
    """[B, S, KVH, D] -> [B, S, heads, D], each kv head repeated for its
    group of query heads."""
    g = heads // t.shape[2]
    return t if g == 1 else torch.repeat_interleave(t, g, dim=2)


def _narrow(t, kv_heads: int):
    """The gradient of `_widen`: [B, S, H, D] summed over each group."""
    B, S, H, D = t.shape
    if H == kv_heads:
        return t
    return t.view(B, S, kv_heads, H // kv_heads, D).sum(3)


class _Shift(torch.autograd.Function):
    """One hop of the plain version's ring: forward this rank's tensor to
    the next rank and take the previous rank's; backward the reverse."""

    @staticmethod
    def forward(ctx, x, link):
        ctx.link = link
        return link.forward_hop(x).wait()

    @staticmethod
    def backward(ctx, g):
        return ctx.link.backward_hop(g).wait(), None


def ring_attention_local(q, k, v, link: RingLink, cp: int, causal=True,
                         scale=None):
    """The plain version: q [B, Sl, H, D], k, v [B, Sl, KVH, D] (KVH
    dividing H), this rank's sequence shard -> [B, Sl, H, D], the
    reference's blockwise float32 softmax over the cp chunks, each chunk's
    probabilities entering PV in v's dtype.  Differentiable (autograd
    through `_Shift`)."""
    B, Sl, H, D = q.shape
    s = scale if scale is not None else 1.0 / math.sqrt(D)
    r = link.rank
    pos = torch.arange(Sl, device=q.device)
    qpos = r * Sl + pos
    qt = q.transpose(1, 2).float()                       # [B, H, Sl, D]
    o = torch.zeros((B, H, Sl, D), dtype=torch.float32, device=q.device)
    m = torch.full((B, H, Sl), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sl), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for t in range(cp):
        if t:
            kv = _Shift.apply(kv, link)
        kc, vc = _widen(kv[0], H), _widen(kv[1], H)
        kpos = ((r - t) % cp) * Sl + pos
        sblk = torch.einsum("bhqd,bkhd->bhqk", qt, kc.float()) * s
        if causal:
            mask = qpos[:, None] >= kpos[None, :]
            sblk = torch.where(mask, sblk, NEG_INF)
        m_new = torch.maximum(m, sblk.amax(-1))
        p = torch.exp(sblk - m_new[..., None])
        if causal:      # a fully masked row's exp(NEG - NEG) = 1 is no mass
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(vc.dtype).float(), vc.float())
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype).transpose(1, 2)


def _lse_rows(lse, B, S, H):
    """lse [B*H, S, 1] -> [B, S, H, 1], the layout of out's rows."""
    return lse.reshape(B, H, S).transpose(1, 2)[..., None]


class RingFlashAttention(torch.autograd.Function):
    """The card path of one rank's ring attention (module docstring):
    q [B, Sl, H, D], k, v [B, Sl, KVH, D].  It saves q, the cp k/v chunks,
    out and the global lse, so a block under remat keeps them and its
    replay never runs the ring."""

    @staticmethod
    def forward(ctx, q, k, v, link, causal, scale):
        B, S, H, D = q.shape
        KVH, cp, c = k.shape[2], link.size, link.rank
        q = q.contiguous()
        kv = torch.stack([k, v])
        chunks: List[torch.Tensor] = []
        out = lse = None
        for t in range(cp):
            chunks.append(kv)
            hop = link.forward_hop(kv) if t < cp - 1 else None
            src = (c - t) % cp
            if not causal or src <= c:
                o_t, lse_t = FA.flash_attention_fwd(
                    q, _widen(kv[0], H), _widen(kv[1], H),
                    causal and t == 0, scale)
                if out is None:
                    out, lse = o_t.float(), lse_t
                else:
                    new = torch.logaddexp(lse, lse_t)
                    out = out * torch.exp(_lse_rows(lse - new, B, S, H)) + \
                        o_t.float() * torch.exp(_lse_rows(lse_t - new, B, S,
                                                          H))
                    lse = new
            if hop is not None:
                kv = hop.wait()
        out = out.to(q.dtype)
        ctx.save_for_backward(q, out, lse, *chunks)
        ctx.link, ctx.causal, ctx.scale, ctx.kv_heads = link, causal, scale, \
            KVH
        return out

    @staticmethod
    def backward(ctx, g):
        q, out, lse, *chunks = ctx.saved_tensors
        link, causal, scale, KVH = ctx.link, ctx.causal, ctx.scale, \
            ctx.kv_heads
        H, cp, c = q.shape[2], link.size, link.rank
        g = g.contiguous()
        delta = FA._delta(out, g)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        acc = hop = None
        # step t's chunk is rank (c - t)'s; its accumulator comes from rank
        # c + 1, which held the chunk at step t + 1, and goes on to c - 1:
        # the hop started after step t + 1 sends this rank's accumulator
        # of that step and brings rank c + 1's, waited for after step t's
        # kernels are queued
        for t in reversed(range(cp)):
            kv = chunks[t]
            part = None
            src = (c - t) % cp
            if not causal or src <= c:
                kk, vv = _widen(kv[0], H), _widen(kv[1], H)
                diag = causal and t == 0
                dq += FA.flash_bwd_dq(q, kk, vv, g, lse, delta, diag,
                                      scale).float()
                dk, dv = FA.flash_bwd_dkv(q, kk, vv, g, lse, delta, diag,
                                          scale)
                part = torch.stack([_narrow(dk.float(), KVH),
                                    _narrow(dv.float(), KVH)])
            acc = hop.wait() if hop is not None else None
            if part is not None:
                acc = part.to(kv.dtype) if acc is None else \
                    (acc.float() + part).to(kv.dtype)
            elif acc is None:
                acc = torch.zeros_like(kv)
            hop = link.backward_hop(acc) if t > 0 else None
        return dq.to(q.dtype), acc[0], acc[1], None, None, None


def ring_attend(q, k, v, link: Optional[RingLink], causal=True, scale=None,
                route: Optional[str] = None):
    """One rank's share of ring attention, differentiable: q [B, Sl, H,
    D], k, v [B, Sl, KVH, D].  `route`: "plain" (`ring_attention_local`),
    "kernels" (`RingFlashAttention`; on CPU tensors the kernels' plain
    versions), or None: the plain version on the CPU, the kernels on the
    card where they take the shapes (D in {64, 128, 256}; the chunks are
    square), else the plain version, counted in
    `flash_attention_fused.composed_calls`.  A ring of one rank (`link`
    None) is the rank's own attention."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if route is None:
        if q.device.type == "cpu":
            route = "plain"
        elif FA.kernel_takes(q, q, causal):
            route = "kernels"
        else:
            FA.flash_attention_fused.composed_calls += 1
            route = "plain"
    if link is None:
        link = RingLink(None, 0, 1)
    if route == "plain":
        return ring_attention_local(q, k, v, link, link.size, causal, s)
    if route != "kernels":
        raise ValueError(f"route must be 'plain' or 'kernels', got {route!r}")
    return RingFlashAttention.apply(q, k, v, link, causal, s)


# ---------------------------------------------------------------------------
# the reference's entry: the full sequence split over a mesh's ranks
# ---------------------------------------------------------------------------

_KEYS = itertools.count(1)


def _rank_ring(key, what, args, *, mesh):
    """`ring_attention`'s work on one rank (`ServingMesh.run`): "fwd" runs
    the rank's share and keeps its graph under `key`; "bwd" takes the
    output gradient and returns the inputs' gradients; "drop" forgets the
    graph."""
    held = mesh.state.setdefault("ring_attention", {})
    if what == "fwd":
        q, k, v, n, causal, scale, route, grad = args
        dev = mesh.device
        q, k, v = (t.to(dev).detach().requires_grad_(grad) for t in (q, k, v))
        link = RingLink.of(ring_group(mesh, list(range(n))), mesh.rank, n) \
            if n > 1 else None
        with torch.set_grad_enabled(grad):
            out = ring_attend(q, k, v, link, causal, scale, route)
        if grad:
            held[key] = (q, k, v, out)
        return out.detach().cpu()
    if what == "bwd":
        q, k, v, out = held.pop(key)
        g = args[0].to(out.device)
        return [t.detach().cpu() for t in
                torch.autograd.grad(out, (q, k, v), g)]
    held.pop(key, None)
    return None


class _MeshRing(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mesh, causal, scale, route, grad):
        n = mesh.mp
        key = next(_KEYS)
        parts = [t.chunk(n, dim=1) for t in (q, k, v)]
        outs = mesh.run(_rank_ring, [
            ((key, "fwd", (parts[0][r], parts[1][r], parts[2][r], n, causal,
                           scale, route, grad)), {}) for r in range(n)])
        ctx.mesh, ctx.key = mesh, key
        return torch.cat(outs, dim=1).to(q.device)

    @staticmethod
    def backward(ctx, g):
        mesh, n = ctx.mesh, ctx.mesh.mp
        gs = g.contiguous().chunk(n, dim=1)
        per = mesh.run(_rank_ring, [((ctx.key, "bwd", (gs[r],)), {})
                                    for r in range(n)])
        dq, dk, dv = (torch.cat([p[i] for p in per], dim=1).to(g.device)
                      for i in range(3))
        return dq, dk, dv, None, None, None, None, None


def ring_attention(q, k, v, mesh, causal=True, scale=None,
                   route: Optional[str] = None):
    """q, k, v [B, S, H|KVH, D], the full sequence on the caller's process
    -> [B, S, H, D]: S split in `mesh.mp` equal shards over the ranks of a
    `parallel.tp` mesh (`serving_mesh`, or `first(n)` of a larger one), in
    rank order, ring attention over them (`ring_attend`, `route` as there),
    the shards concatenated.  Differentiable where grad mode is on and an
    input requires grad: the ranks then keep their graphs until the
    backward."""
    if q.shape[1] % mesh.mp:
        raise AssertionError(f"seq len {q.shape[1]} must divide over "
                             f"cp={mesh.mp}")
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    return _MeshRing.apply(q, k, v, mesh, causal, scale, route, grad)
