"""Attention — port of `paddle_tpu/incubate/kernels/flash_attention.py`:
dense and segment-masked (varlen), forward and backward.

- `attention_ref`: the plain PyTorch version, counterpart of `attention_xla`.
- `flash_attention_fwd`: `(out, lse)` through the hand-written CUDA kernel
  `csrc/flash_attention.cu` (the port of `_flash_fwd_kernel`; bf16 on the
  tensor cores, float32 on the CUDA cores, `FWD_BODY`) on a CUDA tensor,
  or its plain version on a CPU tensor.
- `flash_attention_bwd`: `(dq, dk, dv)` through the two kernels of
  `csrc/flash_attention_bwd.cu` (the ports of `_flash_bwd_dkv_kernel` and
  `_flash_bwd_dq_kernel`; bf16 at D 64/128 on the tensor cores, the rest on
  the CUDA cores, `BWD_BODY`), or `_flash_bwd_ref` on a CPU tensor.
- `flash_attention_fused`: the entry the model calls; differentiable
  through `FlashAttention`, the counterpart of `_flash_attention_core`'s
  `custom_vjp`, which saves `q, k, v, out, lse` for the backward.  On the
  card, shapes the kernels do not take (`kernel_takes`) go to
  `attention_ref`, as the reference sends them to `attention_xla`, counted
  in `flash_attention_fused.composed_calls`.
- `remat_policy_save_attention`: block remat that keeps those tensors and
  replays the rest of the block.
- Varlen: row i sees key j only where `seg_q[b, i] == seg_k[b, j]` (and
  `i >= j` when causal, which needs S == Sk): the TPU's `_seg_mask`.
  `flash_attention_seg_fwd`, `flash_bwd_seg_dkv` and `flash_bwd_seg_dq`
  are the segment-masked instantiations of the CUDA kernels (the backward
  pair's in `csrc/flash_attention_seg_bwd.cu`, on the same bodies as the
  dense pair, `BWD_BODY`; ports of `_flash_fwd_seg_kernel`,
  `_flash_bwd_seg_dkv_kernel`, `_flash_bwd_seg_dq_kernel`; the bf16
  forward and both backward bodies skip the tiles whose segment-id ranges
  are disjoint, where the TPU's skip only causal ones), with plain
  versions `_flash_fwd_seg_ref`,
  `_flash_bwd_seg_dkv_ref`, `_flash_bwd_seg_dq_ref`.  Masked probabilities
  are zeroed after the exp, so a row that sees no key gives out 0 and
  lse = NEG_INF + log(1e-30); `attention_ref_segmented` (the counterpart
  of `attention_xla_segmented`) gives the mean of V there instead.
  `FlashAttentionSeg` is the autograd Function, `flash_attention_varlen`
  the entry (on the card, shapes the kernels do not take go to
  `attention_ref_segmented`, counted in its `composed_calls`).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from . import _cuda

NEG_INF = -1e30


def _causal(q, k):
    """[Sq, Sk] mask keeping row + (Sk - Sq) >= col."""
    Lq, Lk = q.shape[1], k.shape[1]
    row = torch.arange(Lq, device=q.device)[:, None]
    col = torch.arange(Lk, device=q.device)[None, :]
    return row + (Lk - Lq) >= col


def _scores(q, k, causal, scale):
    """f32 scores [B, H, Sq, Sk]; causal keeps row + (Sk - Sq) >= col."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        logits = torch.where(_causal(q, k), logits, NEG_INF)
    return logits


def attention_ref(q, k, v, mask=None, causal=False, scale=None, dropout_p=0.0,
                  generator=None):
    """q,k,v: [B, S, H, D].  Scores and softmax in f32; the probabilities
    enter the PV product in v's dtype (as `attention_xla` does)."""
    D = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(D)
    logits = _scores(q, k, causal, s)
    if mask is not None:
        if mask.dtype == torch.bool:
            logits = torch.where(mask, logits, NEG_INF)
        else:
            logits = logits + mask.float()
    p = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0 and generator is not None:
        keep = torch.rand(p.shape, generator=generator,
                          device=p.device) < 1.0 - dropout_p
        p = torch.where(keep, p / (1.0 - dropout_p), 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _flash_fwd_ref(q, k, v, causal, scale):
    """Plain version of the kernel: (out [B,S,H,D], lse [B*H, S, 1] f32)."""
    B, S, H, _ = q.shape
    logits = _scores(q, k, causal, scale)
    lse = torch.logsumexp(logits, dim=-1)                      # [B, H, S]
    p = torch.exp(logits - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out, lse.reshape(B * H, S, 1)


def _seg_logits(q, k, seg_q, seg_k, causal, scale):
    """`_scores` with segment equality AND-ed into the mask: (f32 logits,
    masked entries at NEG_INF, and the mask [B, 1, S, Sk])."""
    mask = seg_q[:, None, :, None] == seg_k[:, None, None, :]
    if causal:
        mask = mask & _causal(q, k)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    return torch.where(mask, logits, NEG_INF), mask


def _flash_fwd_seg_ref(q, k, v, seg_q, seg_k, causal, scale):
    """Plain version of the segment kernel: (out [B,S,H,D], lse [B*H, S, 1]
    f32), with the kernel's finalize lse = m + log(max(l, 1e-30)) and the
    masked probabilities zeroed."""
    B, S, H, _ = q.shape
    logits, mask = _seg_logits(q, k, seg_q, seg_k, causal, scale)
    m = logits.amax(-1, keepdim=True)
    l = torch.where(mask, torch.exp(logits - m), 0.0).sum(-1, keepdim=True)
    lse = m + torch.log(l.clamp_min(1e-30))                     # [B,H,S,1]
    p = torch.where(mask, torch.exp(logits - lse), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)
    return out, lse.reshape(B * H, S, 1)


def attention_ref_segmented(q, k, v, seg_q, seg_k, causal, scale):
    """Counterpart of `attention_xla_segmented`: `attention_ref` under the
    segment-equality mask (a row that sees no key gets the mean of V)."""
    mask = seg_q[:, None, :, None] == seg_k[:, None, None, :]
    return attention_ref(q, k, v, mask=mask, causal=causal, scale=scale)


def _delta(out, g):
    """rowsum(dO * O) in f32, [B*H, S]: the backward's one residual beyond
    lse (the reference computes it in jnp outside its kernels)."""
    B, S, H, _ = out.shape
    d = (g.float() * out.float()).sum(-1)                      # [B, S, H]
    return d.transpose(1, 2).reshape(B * H, S)


def _bwd_tiles(q, k, v, g, lse, delta, causal, scale, seg=None):
    """The backward's recomputed tiles [B, H, S, Sk]: p = exp(s - lse) in
    f32 (zero where the segment ids `seg = (seg_q, seg_k)` differ), and
    dS = p * (dP - delta) * scale rounded to q's dtype."""
    B, S, H, _ = q.shape
    if seg is None:
        p = torch.exp(_scores(q, k, causal, scale) - lse.reshape(B, H, S, 1))
    else:
        logits, mask = _seg_logits(q, k, *seg, causal, scale)
        p = torch.where(mask, torch.exp(logits - lse.reshape(B, H, S, 1)),
                        0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    ds = p * (dp - delta.reshape(B, H, S, 1)) * scale
    return p, ds.to(q.dtype).float()


def _flash_bwd_dkv_ref(q, k, v, g, lse, delta, causal, scale, seg=None):
    """Plain version of the dkv kernel: p enters dV in dO's dtype; every
    product accumulates in f32."""
    p, ds = _bwd_tiles(q, k, v, g, lse, delta, causal, scale, seg)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).float(), g.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_dq_ref(q, k, v, g, lse, delta, causal, scale, seg=None):
    """Plain version of the dq kernel."""
    _, ds = _bwd_tiles(q, k, v, g, lse, delta, causal, scale, seg)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def _flash_bwd_ref(q, k, v, out, lse, g, causal, scale, seg=None):
    """Plain version of the backward pair: (dq, dk, dv) in q/k/v's dtypes,
    rounding where the kernels do: p enters dV in dO's dtype, dS is cast to
    q's dtype before both dK and dQ."""
    delta = _delta(out, g)
    dk, dv = _flash_bwd_dkv_ref(q, k, v, g, lse, delta, causal, scale, seg)
    return _flash_bwd_dq_ref(q, k, v, g, lse, delta, causal, scale, seg), \
        dk, dv


def _flash_bwd_seg_dkv_ref(q, k, v, g, lse, delta, seg_q, seg_k, causal,
                           scale):
    """Plain version of the segment dkv kernel."""
    return _flash_bwd_dkv_ref(q, k, v, g, lse, delta, causal, scale,
                              (seg_q, seg_k))


def _flash_bwd_seg_dq_ref(q, k, v, g, lse, delta, seg_q, seg_k, causal,
                          scale):
    """Plain version of the segment dq kernel."""
    return _flash_bwd_dq_ref(q, k, v, g, lse, delta, causal, scale,
                             (seg_q, seg_k))


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The forward body each dtype runs on the card (flash_attention.cu's
# dispatch): bf16 the tensor-core body (attention_wgmma.cuh), float32 the
# CUDA-core one (attention_tile.cuh), since tensor cores in f32 mean TF32.
FWD_BODY = {torch.bfloat16: "wgmma", torch.float32: "cuda_core"}
# The backward pair's body by (dtype, D, segment-masked), from the dispatch
# of csrc/flash_attention_bwd.cu and flash_attention_seg_bwd.cu: the bf16
# pair at D = 64 and 128, dense and segment-masked, runs the tensor-core
# body (attention_bwd_wgmma.cuh); float32 and D = 256 (whose dK and dV
# accumulators fill a thread's registers) the CUDA-core one
# (attention_bwd_tile.cuh).
BWD_BODY = {(dtype, D, seg): "wgmma" if dtype == torch.bfloat16 and
            D != 256 else "cuda_core"
            for dtype in _DTYPE_CODE for D in (64, 128, 256)
            for seg in (False, True)}


def kernel_takes(q, k, causal):
    """Whether the attention kernels take these shapes ([B, S|Sk, H, D]):
    D in {64, 128, 256}, and S == Sk when causal.  The entries send other
    shapes on the card to the plain route, as the reference's
    `_shapes_ok_for_pallas` sends them to its XLA twin."""
    return q.shape[-1] in (64, 128, 256) and \
        (not causal or q.shape[1] == k.shape[1])


def _check_card(name, q, k, v, causal, *more):
    """The kernels' contract on the card: one CUDA device, float32 or
    bfloat16, [B, S|Sk, H, D] with D in {64, 128, 256}, S == Sk when
    causal, 16-byte aligned rows.  Returns the contiguous inputs."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    ts = (q, k, v) + more
    if q.device.type != "cuda" or any(t.device != q.device for t in ts):
        raise ValueError(f"{name}: q, k, v must share one CUDA device")
    if q.dtype not in _DTYPE_CODE or any(t.dtype != q.dtype for t in ts):
        raise TypeError(f"{name} takes float32/bfloat16 tensors of one "
                        f"dtype, got {[t.dtype for t in ts]}")
    if D not in (64, 128, 256) or k.shape != (B, Sk, H, D) or \
            v.shape != k.shape or any(t.shape != q.shape for t in more):
        raise ValueError(f"{name}: unsupported shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    if causal and Sk != S:
        raise ValueError(f"causal flash attention needs S == Sk, got {S} "
                         f"and {Sk}")
    ts = tuple(t.contiguous() for t in ts)
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError(f"{name} needs 16-byte aligned tensors")
    return ts


def _check_seg(name, q, k, seg_q, seg_k):
    """Segment ids on the card: int32 [B, S] and [B, Sk] on q's device.
    Returns them contiguous."""
    B, S = q.shape[:2]
    for t, want in ((seg_q, (B, S)), (seg_k, (B, k.shape[1]))):
        if t.dtype != torch.int32 or tuple(t.shape) != want or \
                t.device != q.device:
            raise ValueError(f"{name}: segment ids {tuple(t.shape)} "
                             f"{t.dtype} are not {want} int32 on {q.device}")
    return seg_q.contiguous(), seg_k.contiguous()


def flash_attention_fwd(q, k, v, causal, scale):
    """[B,S,H,D] -> (out [B,S,H,D], lse [B*H, S, 1] f32).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (D in {64, 128, 256}, float32 or bfloat16, causal needs S == Sk) or
    raise.  `flash_attention_fwd.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return _flash_fwd_ref(q, k, v, causal, scale)
    q, k, v = _check_card("flash_attention_fwd", q, k, v, causal)
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B * H, S, 1), dtype=torch.float32, device=q.device)
    fn = _cuda.entry("flash_attention", "flash_attention_fwd")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), B, S, k.shape[1], H, D, int(bool(causal)),
             float(scale), _DTYPE_CODE[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention_seg_fwd(q, k, v, seg_q, seg_k, causal, scale):
    """`flash_attention_fwd` under the segment mask (seg_q [B, S], seg_k
    [B, Sk] int32): the segment instantiation of the forward kernel on the
    card, `_flash_fwd_seg_ref` on the CPU.  `.launches` counts kernel
    launches."""
    if q.device.type == "cpu":
        return _flash_fwd_seg_ref(q, k, v, seg_q, seg_k, causal, scale)
    q, k, v = _check_card("flash_attention_seg_fwd", q, k, v, causal)
    seg_q, seg_k = _check_seg("flash_attention_seg_fwd", q, k, seg_q, seg_k)
    B, S, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B * H, S, 1), dtype=torch.float32, device=q.device)
    fn = _cuda.entry("flash_attention", "flash_attention_seg_fwd")
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(),
             seg_k.data_ptr(), out.data_ptr(), lse.data_ptr(), B, S,
             k.shape[1], H, D, int(bool(causal)), float(scale),
             _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device)
             .cuda_stream)
    _cuda.check(err, "flash_attention_seg_fwd")
    flash_attention_seg_fwd.launches += 1
    return out, lse


flash_attention_seg_fwd.launches = 0


def _bwd_launch_args(name, q, k, v, g, lse, delta, causal, scale):
    """Checked, contiguous inputs of a backward kernel as (the tensors q,
    k, v, g, lse, delta, sizes and flags).  The caller holds the tensors
    until its launch is queued: a contiguous copy made here that only its
    pointer outlived would go back to the allocator, and the kernel's own
    outputs could be given its memory."""
    q, k, v, g = _check_card(name, q, k, v, causal, g)
    B, S, H, D = q.shape
    for t, want in ((lse, (B * H, S, 1)), (delta, (B * H, S))):
        if tuple(t.shape) != want or t.dtype != torch.float32 or \
                t.device != q.device:
            raise ValueError(f"{name}: lse/delta {tuple(t.shape)} {t.dtype} "
                             f"is not {want} float32 on {q.device}")
    return (q, k, v, g, lse.contiguous(), delta.contiguous()), \
        (B, S, k.shape[1], H, D, int(bool(causal)), float(scale),
         _DTYPE_CODE[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)


def _ptrs(ts):
    return tuple(t.data_ptr() for t in ts)


def flash_bwd_dkv(q, k, v, g, lse, delta, causal, scale):
    """(dk, dv) given dO = g, lse [B*H, S, 1] and delta = rowsum(dO * O)
    [B*H, S]: the kernel port of `_flash_bwd_dkv_kernel` on the card (under
    the forward kernel's contract, or raise), its plain version on the
    CPU.  `.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return _flash_bwd_dkv_ref(q, k, v, g, lse, delta, causal, scale)
    ts, dims = _bwd_launch_args("flash_bwd_dkv", q, k, v, g, lse, delta,
                                causal, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _cuda.entry("flash_attention_bwd", "flash_attention_bwd_dkv")
    _cuda.check(fn(*_ptrs(ts), dk.data_ptr(), dv.data_ptr(), *dims),
                "flash_attention_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, g, lse, delta, causal, scale):
    """dq, as `flash_bwd_dkv` (the port of `_flash_bwd_dq_kernel`)."""
    if q.device.type == "cpu":
        return _flash_bwd_dq_ref(q, k, v, g, lse, delta, causal, scale)
    ts, dims = _bwd_launch_args("flash_bwd_dq", q, k, v, g, lse, delta,
                                causal, scale)
    dq = torch.empty_like(q)
    fn = _cuda.entry("flash_attention_bwd", "flash_attention_bwd_dq")
    _cuda.check(fn(*_ptrs(ts), dq.data_ptr(), *dims),
                "flash_attention_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0


def flash_bwd_seg_dkv(q, k, v, g, lse, delta, seg_q, seg_k, causal, scale):
    """`flash_bwd_dkv` under the segment mask: the port of
    `_flash_bwd_seg_dkv_kernel` on the card, `_flash_bwd_seg_dkv_ref` on
    the CPU.  `.launches` counts kernel launches."""
    if q.device.type == "cpu":
        return _flash_bwd_seg_dkv_ref(q, k, v, g, lse, delta, seg_q, seg_k,
                                      causal, scale)
    ts, dims = _bwd_launch_args("flash_bwd_seg_dkv", q, k, v, g, lse,
                                delta, causal, scale)
    seg_q, seg_k = _check_seg("flash_bwd_seg_dkv", q, k, seg_q, seg_k)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = _cuda.entry("flash_attention_seg_bwd", "flash_attention_seg_bwd_dkv")
    _cuda.check(fn(*_ptrs(ts), seg_q.data_ptr(), seg_k.data_ptr(),
                   dk.data_ptr(),
                   dv.data_ptr(), *dims), "flash_attention_seg_bwd_dkv")
    flash_bwd_seg_dkv.launches += 1
    return dk, dv


def flash_bwd_seg_dq(q, k, v, g, lse, delta, seg_q, seg_k, causal, scale):
    """dq, as `flash_bwd_seg_dkv` (the port of `_flash_bwd_seg_dq_kernel`)."""
    if q.device.type == "cpu":
        return _flash_bwd_seg_dq_ref(q, k, v, g, lse, delta, seg_q, seg_k,
                                     causal, scale)
    ts, dims = _bwd_launch_args("flash_bwd_seg_dq", q, k, v, g, lse, delta,
                                causal, scale)
    seg_q, seg_k = _check_seg("flash_bwd_seg_dq", q, k, seg_q, seg_k)
    dq = torch.empty_like(q)
    fn = _cuda.entry("flash_attention_seg_bwd", "flash_attention_seg_bwd_dq")
    _cuda.check(fn(*_ptrs(ts), seg_q.data_ptr(), seg_k.data_ptr(),
                   dq.data_ptr(),
                   *dims), "flash_attention_seg_bwd_dq")
    flash_bwd_seg_dq.launches += 1
    return dq


flash_bwd_seg_dkv.launches = 0
flash_bwd_seg_dq.launches = 0


def flash_attention_bwd(q, k, v, out, lse, g, causal, scale):
    """Gradients (dq, dk, dv) of `flash_attention_fwd`'s out, given its
    residuals out, lse [B*H, S, 1] and the output gradient g [B,S,H,D]:
    delta = rowsum(dO * O) in plain torch (as the reference), then the dkv
    and dq kernels on the card or their plain versions on the CPU."""
    g = g.contiguous()
    delta = _delta(out, g)
    dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, causal, scale)
    return flash_bwd_dq(q, k, v, g, lse, delta, causal, scale), dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention: the forward kernel, saving
    `q, k, v, out, lse`, and the backward pair (plain versions on the CPU).
    Under `run_blocks(remat=True)` these saved tensors are what a block
    keeps, so the backward never re-runs attention."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, ctx.causal,
                                         ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_fused(q, k, v, mask=None, causal=False, scale=None,
                          dropout_p=0.0, generator=None):
    """Entry used by the model.  q,k,v: [B, S, H, D].  Differentiable.  On
    the card, shapes the kernels do not take go to `attention_ref` (causal
    keeps row + (Sk - Sq) >= col), counted in `.composed_calls`; a mask or
    dropout raises (their lanes are not ported yet).  The CPU keeps the
    plain versions for all of them."""
    D = q.shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(D)
    if mask is None and dropout_p == 0.0:
        if q.device.type != "cpu" and not kernel_takes(q, k, causal):
            flash_attention_fused.composed_calls += 1
            return attention_ref(q, k, v, causal=causal, scale=s)
        return FlashAttention.apply(q, k, v, causal, s)
    if q.device.type != "cpu":
        raise NotImplementedError(
            "flash_attention_fused with mask/dropout on the card arrives "
            "with a later slice (ROADMAP Queue 1: the rest of training, "
            "mask and dropout lanes)")
    return attention_ref(q, k, v, mask=mask, causal=causal, scale=s,
                         dropout_p=dropout_p, generator=generator)


flash_attention_fused.composed_calls = 0


def flash_attention_mp(q, k, v, mesh, causal=True, scale=None):
    """The head-sharded dense flash forward of the bucketed prefill under
    tensor-parallel serving (the reference's `shard_map` of
    `flash_attention_fused` over the "mp" axis): q, k, v [B, S, H/mp, hd]
    are one rank's heads, and attention never mixes heads, so the rank runs
    the unmodified kernel on them (`flash_attention_fused`, its routing
    included)."""
    if q.shape[2] != k.shape[2] or k.shape != v.shape:
        raise ValueError(f"rank {mesh.rank}: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not one "
                         f"rank's heads of one attention")
    return flash_attention_fused(q, k, v, causal=causal, scale=scale)


def flash_attention_seg_bwd(q, k, v, seg_q, seg_k, out, lse, g, causal,
                            scale):
    """`flash_attention_bwd` under the segment mask: delta in plain torch,
    then the segment dkv and dq kernels (plain versions on the CPU)."""
    g = g.contiguous()
    delta = _delta(out, g)
    dk, dv = flash_bwd_seg_dkv(q, k, v, g, lse, delta, seg_q, seg_k, causal,
                               scale)
    return flash_bwd_seg_dq(q, k, v, g, lse, delta, seg_q, seg_k, causal,
                            scale), dk, dv


class FlashAttentionSeg(torch.autograd.Function):
    """Differentiable segment-masked attention, the counterpart of
    `_flash_attention_seg_core`'s `custom_vjp`: the segment forward kernel,
    saving `q, k, v, seg_q, seg_k, out, lse`, and the segment backward pair
    (plain versions on the CPU).  The integer segment ids get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_k, causal, scale):
        out, lse = flash_attention_seg_fwd(q, k, v, seg_q, seg_k, causal,
                                           scale)
        ctx.save_for_backward(q, k, v, seg_q, seg_k, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, seg_q, seg_k, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_seg_bwd(q, k, v, seg_q, seg_k, out, lse,
                                             g, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention_varlen(q, k, v, segment_ids, kv_segment_ids=None,
                           causal=True, scale=None):
    """Segment-masked attention (varlen packing): q, k, v [B, S, H, D],
    segment_ids [B, S] (kv_segment_ids [B, Sk], default the same) — tokens
    attend only within their own segment.  Differentiable.  The kernels on
    the card (float32 or bfloat16, or raise) where `kernel_takes` the
    shapes, else `attention_ref_segmented`, counted in `.composed_calls`;
    their plain versions on the CPU."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    seg_q = torch.as_tensor(segment_ids, device=q.device).to(torch.int32)
    seg_k = seg_q if kv_segment_ids is None else \
        torch.as_tensor(kv_segment_ids, device=q.device).to(torch.int32)
    if q.device.type != "cpu" and not kernel_takes(q, k, causal):
        flash_attention_varlen.composed_calls += 1
        return attention_ref_segmented(q, k, v, seg_q, seg_k, causal, s)
    return FlashAttentionSeg.apply(q, k, v, seg_q, seg_k, causal, s)


flash_attention_varlen.composed_calls = 0


def remat_policy_save_attention(qkv_fn, attend, tail_fn, x):
    """The port's counterpart of the reference's policy of the same name
    (a block's `jax.checkpoint` saves only `flash_qkv`, `flash_out` and
    `flash_lse`): runs `qkv_fn(x) -> (q, k, v)` and `tail_fn(x, out)` each
    under a non-reentrant `torch.utils.checkpoint`, and `attend(q, k, v)
    -> out` between them outside any checkpoint.  The block then keeps x
    and what `FlashAttention` saves (q, k, v, out, lse); its backward
    replays the norm/qkv/rope and the proj/FFN chains but never re-runs
    attention."""
    q, k, v = checkpoint(qkv_fn, x, use_reentrant=False)
    return checkpoint(tail_fn, x, attend(q, k, v), use_reentrant=False)
