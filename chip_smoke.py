#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each (with its seconds):
1. device   — requires CUDA, prints the card's name and power limit,
               disables TF32 for the float32 references, builds the CUDA
               kernels (one nvcc per source, in parallel); each source's
               build seconds, ptxas's register/spill/serialization lines,
               and per tensor-core backward kernel (dense and SEG), per
               paged prefill kernel (`ptxas_paged_prefill`, 48
               instantiations: 24 over a pool of q's dtype, 24 over an
               int8 pool), per paged decode kernel (`ptxas_paged_decode`,
               96: 48 and 48) and per RMSNorm kernel
               (`ptxas_rms_norm`, 40 register and 4 ring kernels) its
               registers and spills, none of which may spill.
2. kernels  — each hand-written kernel against its plain PyTorch version on
               the same numpy-seeded inputs at the serving shapes (and the
               flash forward at the training shape [4,2048,16,128] too), in
               bf16 and float32: max abs error (valid rows only for paged
               attention), kernel/plain/library times (CUDA events); each
               flash-forward result names the body that ran (`body`: the
               tensor-core `wgmma` body in bf16, `cuda_core` in float32);
               the paged prefill rows (T 1 and 16) give the split plan
               (ck, nsplit, gc, row tiles), each slot's lane, the kernel's
               device time at other ck (`ck_sweep_device_ms`), and hold
               padding rows 0 and two calls bitwise equal; the decode rows
               give their split plan, hold two calls bitwise equal and, at
               Llama-3-8B's heads, sweep ck and warps a block
               (`ck_warps_sweep_device_ms`); RMSNorm runs at [4096, 4096],
               [8, 4096] and [128, 4096], holds two calls bitwise equal,
               and sweeps its wide-row launch shape
               (`launch_sweep_device_ms`).  The paged, decode and RMSNorm
               rows also give the kernel's and the library call's device
               time (`device_ms`, `library_device_ms`: the calls timed
               behind a sleep kernel, without the host's launch cost).
               The int8 lanes of both paged kernels (`"kv": "int8"` rows:
               an int8 pool with f32 scales as `_quantize_kv` writes it) run
               at the same shapes, page 16 and 32, bf16 and float32 q,
               against their plain versions (float32 F32_TOL; bf16
               INT8_BF16_TOL, one bf16 rounding of the output, since
               neither rounds p), with their own ck sweeps; the library
               yardstick is SDPA over a gathered copy dequantized outside
               the timed call.
3. engine_bucketed — Llama-3-8B at full width (all 32 layers), bf16, random
               weights from a seeded generator, 8 greedy requests of 64-1024
               prompt tokens x 32 new tokens through `LLMEngine` with
               one-shot bucketed prefill (buckets 512, 1024 and 2048, so the
               prompts take two prefill programs, the reference's budget);
               the engine's decode-side program is warmed (`warm_decode`:
               its CUDA graph captured) before launch counts are zeroed, and
               the counts are read just after.  Every fused step is one
               graph replay (`graph_replays` = fused dispatches, the
               replays adding their captures' launch counts), the program
               counts (`*_executables`) stay within `SERVE_PROGRAM_BUDGET`
               with one decode-side program, and the engine's memory (pool,
               graphs) is released when it is dropped.
4. engine_chunked  — the same requests with `prefill_chunk=16`, the chunk
               riding the fused step; greedy agreement with phase 3 printed.
5. engine_unfused — the same requests through `LLMEngine(fuse=False)`, the
               three-program step, bucketed and chunked (`prefill_chunk=16`),
               the decode and chunk programs one replay each: tokens/s, step
               ms, peak memory, and exact launch counts (the paged decode
               kernel 32 x decode dispatches, paged prefill 32 x chunk
               dispatches, flash forward 32 x bucketed prefills); greedy
               agreement with phases 3 and 4 printed, not required (the
               kernels sum in other orders in bf16).
6. engine_graphs — phases 3 and 4 again without CUDA graphs (the engine's
               private `_eager` switch), in the same process: both modes'
               tokens/s, step ms, peak memory, replays and program counts;
               the streams must be identical and the launch counts equal.
6b. engine_int8 — the same requests through `LLMEngine(weight_dtype=
               "int8", kv_dtype="int8")`, page 32, on graphs: fused
               bucketed, fused chunked (`prefill_chunk=16`) and `fuse=False`
               bucketed.  Each: tokens/s, step ms, peak memory,
               `kv_pool_bytes` beside the bf16 pool's at the same geometry,
               the int8 lanes' launches (`launches_int8`: 32 x the
               dispatches that reach each lane, no fp paged launch), no
               composed call, the programs within the budget, greedy
               agreement with the bf16 phases (printed, not required); and
               the bucketed engine's first token of prompts 0 and 1 equal to
               the argmax of the dense `forward` over the dequantized
               weights where the top-2 margin exceeds 0.05.
7. first_token — the first tokens of phases 3, 4 and both modes of 5 for
               two prompts against the argmax of the dense `forward` at the
               last prompt position, held equal where the top-2 margin
               exceeds 0.05 (ties printed).
8. decode_logits — one `prefill_paged` of prompt 0, then `decode_step_paged`
               on its greedy next token: argmax equal to the dense
               `forward`'s over prompt + token where the margin exceeds 0.05.
9. kernels_bwd — the flash backward pair (dkv and dq kernels) against
               `_flash_bwd_ref` at [1,1024,32,128] causal, the training
               shape [4,2048,16,128] causal and [2,333,8,64] full, in bf16
               and float32: max abs errors, dkv/dq/pair/plain ms, the
               backward alone of SDPA as the library yardstick, bounds, the
               body that ran (`body`: `wgmma` for the dense bf16 pair at D 64
               and 128, `BWD_BODY`), and at the training shape two calls'
               dq, dk, dv bitwise equal; then RMSNorm's dx, dw through its
               autograd Function against autograd through `_rms_ref`.
10. varlen     — GPT-3 1.3B attention width (H 16, D 128), bf16 and float32:
               8192 packed tokens in segments of 128-2048 through
               `flash_attn_unpadded(causal=True)` forward and backward (the
               segment-masked forward, dkv and dq kernels, once each; no
               composed route may run), held against the plain versions;
               two calls of the segment backward pair bitwise equal; the
               tiles the bf16 bodies keep after skipping by segment-id range
               (counted on the host from the ids) beside the causal walk's;
               the body each half runs (`fwd_body`, `bwd_body`); a
               non-causal case with other key offsets and
               `flash_attention(segment_ids=)` at [4,2048,16,128]; kernel,
               plain, SDPA (block-diagonal mask) and bound times, beside the
               dense kernels at [4,2048,16,128].
11. train_parity — float32, TF32 off, Llama-3-8B width with 2 layers, B=1,
               S=1024: `loss_fn` and its gradients through the kernels
               against the same with `attn_impl=attention_ref`.
12. train      — GPT-3 1.3B (`gpt3_1p3b`, 24 layers), bf16 params and
               moments, remat, B=4, S=2048, through `HybridParallelTrainer`:
               1 warm-up and 4 timed steps on one repeated batch; tokens/s,
               step ms, peak memory, losses, launches per step.

Then one line `{"kernels": [...]}` for all nine kernels and the int8 lanes of
the two paged ones (launches summed over the main-path runs of phases 3, 4,
5, 6b, 10, 11 and 12, each with the counts
zeroed just before it and read just after; none of them may take an
entry's composed route for shapes the kernels do not take) and, last,
`{"ok": true, "device": ...}`.
Exits non-zero, with no result line, without CUDA, outside the repository,
or when any phase fails.
"""
import json
import math
import re
import subprocess
import sys
import time

import numpy as np

BF16_TOL = dict(atol=2e-2, rtol=2e-2)   # bf16 rounding of P before PV
INT8_BF16_TOL = dict(atol=1e-2, rtol=1e-2)  # int8 lanes, bf16 q: p stays
#                                             f32, one bf16 output rounding
F32_TOL = 1e-4                          # same math, other summation order
BWD_BF16_REL = 2e-2     # backward, bf16: max abs err <= 2e-2 * max|ref|
BWD_F32_REL = 1e-4      # backward, f32: <= 1e-4 * max(1, max|ref|)
H100_BYTES_S = 3.35e12                  # HBM3, NVIDIA data sheet (SXM)
H100_BF16_FLOPS = 989e12                # dense tensor-core bf16
H100_F32_FLOPS = 67e12                  # float32 outside the tensor cores
MAX_NEW = 32
PROMPT_LENS = (64, 96, 160, 256, 384, 512, 768, 1024)
SERVE_BUCKETS = [512, 1024, 2048]       # the prompts take two of them
INT8_PAGE = 32          # the int8 engines' page (the reference's int8 gate)
RELEASE_SLACK = 128 << 20   # bytes a dropped engine may leave (cuBLAS's
#                             workspace on the capture stream, made once)


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, warmup=3):
    """Device time of one call: a sleep kernel holds the card while the
    host enqueues the calls, so the events time them back to back on the
    device, without the host's launch cost that `time_ms` includes where
    the kernel is shorter than it."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)           # ~10 ms; 20 calls enqueue in ~1
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_kernels(log, match):
    """[entry function, its "Used ... registers" line, its spill line] for
    each entry function whose mangled name contains `match`, from the
    `nvcc -Xptxas -v` report `log`."""
    found, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"entry function '(\S+)'", ln)
        if m:
            fn = m.group(1)
            if match in fn:
                found.setdefault(fn, ["", ""])
        elif fn in found and "Used" in ln:
            found[fn][0] = ln.strip()
        elif fn in found and "spill" in ln:
            found[fn][1] = ln.strip()
    return [[fn, *v] for fn, v in found.items()]


def no_spills(rows):
    """Raise if a `ptxas_kernels` row reports spill stores or loads."""
    for fn, _, spill in rows:
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      spill)
        if m is None or m.groups() != ("0", "0"):
            raise AssertionError(f"{fn} spills: {spill!r}")


def no_composed(what):
    """Raise if a model-facing entry took its composed route since the
    counts were zeroed (the full-width paths run the kernels only)."""
    from paddle_tpu_torch.incubate import kernels as K
    routed = K.composed_calls()
    if any(routed.values()):
        raise AssertionError(f"{what}: composed routes taken {routed}")


def bound(nbytes, flops, peak_flops):
    t_bytes = nbytes / H100_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def check_close(name, got, ref, dtype, bf16_tol=BF16_TOL):
    import torch
    err = float((got.float() - ref.float()).abs().max())
    if dtype == torch.float32:
        ok = err <= F32_TOL
    else:
        ok = bool(torch.allclose(got.float(), ref.float(), **bf16_tol))
    if not ok:
        raise AssertionError(f"{name} ({dtype}): kernel disagrees with its "
                             f"plain version, max abs err {err:.3g}")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def rms_case(dtype, dev, N, D=4096):
    """RMSNorm at [N, D] through `rms_norm_fused` alone: `kernel_ms` (CUDA
    events around 20 host calls: the wrapper's host cost per call where the
    kernel is shorter than it, as at the serving step's N = 8),
    `device_ms`, and the library call's two readings."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.incubate.kernels.rms_norm import _rms_ref, \
        rms_norm_fused
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(N, D).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy(rng.randn(D).astype(np.float32)).to(dev, dtype)
    got = rms_norm_fused(x, w)
    ref = _rms_ref(x, w, 1e-6)
    if not torch.equal(got, rms_norm_fused(x, w)):
        raise AssertionError(f"rms_norm [{N}, {D}] ({dtype}): two calls on "
                             f"the same inputs differ")
    isz = x.element_size()
    b, by = bound((2 * N * D + D) * isz, 4 * N * D, H100_F32_FLOPS)
    return {
        "kernel": "rms_norm", "shape": [N, D], "bitwise_deterministic": True,
        "max_abs_err": check_close("rms_norm", got, ref, dtype),
        "kernel_ms": time_ms(lambda: rms_norm_fused(x, w)),
        "device_ms": device_ms(lambda: rms_norm_fused(x, w)),
        "plain_ms": time_ms(lambda: _rms_ref(x, w, 1e-6)),
        "library_ms": time_ms(lambda: F.rms_norm(x, (D,), w, 1e-6)),
        "library_device_ms": device_ms(lambda: F.rms_norm(x, (D,), w, 1e-6)),
        "bound_ms": b, "bound_by": by}


def rms_launch_sweep(dtype, dev, N, D=4096):
    """RMSNorm's launch shape at [N, D] and its device time under other
    launch shapes, keyed "threads x rows / s stages" by the shape the plan
    takes: threads a wide row and rows of x in flight on the ring kernel
    (s0: the register kernel instead)."""
    import torch
    from paddle_tpu_torch.incubate.kernels import rms_norm as RN
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(N, D).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy(rng.randn(D).astype(np.float32)).to(dev, dtype)
    isz = x.element_size()
    plan = RN._rms_launch(D, isz, isz, True, RN.RMS_NARROW, RN.RMS_WIDE,
                          RN.RMS_STAGES)
    sweep, base = {}, (RN.RMS_WIDE, RN.RMS_STAGES)
    for threads in (128, 256, 512, 1024):
        for stages in (0, 2, 4, 8):
            took = RN._rms_launch(D, isz, isz, True, RN.RMS_NARROW,
                                  (threads, 1), stages)
            RN.RMS_WIDE, RN.RMS_STAGES = (threads, 1), stages
            try:
                sweep[f"{took.threads}x{took.rows}/s{took.stages}"] = \
                    device_ms(lambda: RN.rms_norm_fused(x, w))
            finally:
                RN.RMS_WIDE, RN.RMS_STAGES = base
    return {"launch": dict(plan._asdict()), "launch_sweep_device_ms": sweep}


def flash_case(dtype, dev, shape):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.incubate.kernels.flash_attention import (
        FWD_BODY, _flash_fwd_ref, flash_attention_fwd)
    B, S, H, D = shape
    rng = np.random.RandomState(S)
    q, k, v = (torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32))
               .to(dev, dtype) for _ in range(3))
    scale = 1.0 / math.sqrt(D)
    out, lse = flash_attention_fwd(q, k, v, True, scale)
    ref, ref_lse = _flash_fwd_ref(q, k, v, True, scale)
    err = check_close("flash_attention", out, ref, dtype)
    lse_err = float((lse - ref_lse).abs().max())
    if lse_err > 1e-3:
        raise AssertionError(f"flash lse disagrees: {lse_err:.3g}")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    isz = q.element_size()
    flops = 4 * B * H * D * S * (S + 1) // 2        # causal: keys <= row
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    b, by = bound(4 * B * S * H * D * isz + B * H * S * 4, flops, peak)
    return {
        "kernel": "flash_attention_fwd", "S": S, "shape": [B, S, H, D],
        "body": FWD_BODY[dtype], "max_abs_err": err,
        "lse_max_abs_err": lse_err,
        "kernel_ms": time_ms(lambda: flash_attention_fwd(q, k, v, True,
                                                         scale)),
        "plain_ms": time_ms(lambda: _flash_fwd_ref(q, k, v, True, scale)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        "bound_ms": b, "bound_by": by}


def paged_inputs(dtype, dev, T, page=16):
    """B=8, H=32, KVH=8, hd=128, 2048 tokens a table row, mixed
    q_offset/valid; slots 6 and 7 are null-table slots (valid 1, offset 0)."""
    import torch
    rng = np.random.RandomState(T)
    B, H, KVH, hd, max_pages = 8, 32, 8, 128, 2048 // page
    if T == 1:
        q_offset = np.array([0, 37, 300, 1000, 1500, 2040, 0, 0])
        valid = np.ones(B, np.int64)
    else:
        q_offset = np.array([0, 37, 300, 1000, 1500, 63, 0, 0])
        valid = np.array([16, 5, 16, 1, 9, 16, 1, 1])
    table = np.zeros((B, max_pages), np.int32)
    need = [-(-(q_offset[b] + valid[b]) // page) for b in range(6)]
    P = 1 + sum(need)
    perm = list(rng.permutation(np.arange(1, P)))
    for b in range(6):
        table[b, :need[b]] = [perm.pop() for _ in range(need[b])]

    def rnd(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)) \
            .to(dev, dtype)

    args = (rnd(B, T, H, hd), rnd(P, page, KVH, hd), rnd(P, page, KVH, hd),
            torch.from_numpy(table).to(dev),
            torch.from_numpy(q_offset.astype(np.int32)).to(dev),
            torch.from_numpy(valid.astype(np.int32)).to(dev))
    return args, q_offset, valid


def int8_pool(kp, vp):
    """The int8 pool and (k_scale, v_scale) that `_quantize_kv` writes for
    the float pool kp, vp."""
    from paddle_tpu_torch.models.gpt import _quantize_kv
    (kq, ks), (vq, vs) = (_quantize_kv(x.float()) for x in (kp, vp))
    return kq, vq, (ks, vs)


def dequantized(pages, scales, dtype):
    """An int8 pool dequantized into `dtype` (the library yardstick's
    input, made outside the timed call)."""
    return (pages.float() * scales[..., None]).to(dtype)


def paged_case(dtype, dev, T, page=16, int8=False):
    """The paged prefill kernel against its plain version; `int8`: its int8
    lane over the int8 pool `_quantize_kv` makes of the same inputs."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.incubate.kernels import paged_attention as PA
    from paddle_tpu_torch.incubate.kernels.paged_attention import (
        _prefill_split_plan, paged_prefill_attention_kernel,
        paged_prefill_attention_ref)
    args, q_offset, valid = paged_inputs(dtype, dev, T, page)
    kw, kd, vd = {}, args[1], args[2]
    if int8:
        kq, vq, scales = int8_pool(args[1], args[2])
        args = (args[0], kq, vq, *args[3:])
        kw = {"kv_scales": scales}
        kd, vd = (dequantized(x, sc, dtype) for x, sc in zip((kq, vq),
                                                             scales))

    def call():
        return paged_prefill_attention_kernel(*args, **kw)
    got = call()
    ref = paged_prefill_attention_ref(*args, **kw)
    tol = INT8_BF16_TOL if int8 else BF16_TOL
    err = max(check_close("paged_attention", got[b, :n], ref[b, :n], dtype,
                          tol)
              for b, n in enumerate(valid))
    if any(bool(got[b, n:].any()) for b, n in enumerate(valid)):
        raise AssertionError(f"paged_attention T={T} ({dtype}): padding "
                             f"rows are not 0")
    # the split merge reads the partials in split order: the same bits on
    # every call
    if not torch.equal(got, call()):
        raise AssertionError(f"paged_attention T={T} ({dtype}): two calls "
                             f"on the same inputs differ")
    q, kp, vp, table, qo, vl = args
    B, _, H, hd = q.shape
    P, page, KVH, _ = kp.shape
    plan = _prefill_split_plan(B, T, H, KVH, hd, page, table.shape[1],
                               PA.PREFILL_CK)
    isz = q.element_size()
    # what this data needs: each slot's keys up to its last real query
    # (K and V rows, with their f32 scales for an int8 pool), each valid
    # row's causal span; the int8 lane's math is f32 (the reference's lane)
    keys = sum(int(q_offset[b] + valid[b]) for b in range(B))
    row = hd + 4 if int8 else hd * isz
    nbytes = (2 * B * T * H * hd * isz + 2 * keys * KVH * row
              + table.numel() * 4 + 2 * B * 4)
    flops = sum(4 * H * hd * (int(q_offset[b]) + t + 1)
                for b in range(B) for t in range(int(valid[b])))
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 and not int8 else \
        H100_F32_FLOPS
    b_ms, by = bound(nbytes, flops, peak)
    kernel_ms = time_ms(call)
    # the kernel at other keys a block, for tuning the plan's ck (keyed by
    # the ck the plan takes, which grows where the workspace would pass
    # its cap)
    sweep, base = {}, PA.PREFILL_CK
    for ck in (64, 128, 256, 512):
        PA.PREFILL_CK = ck
        try:
            took = _prefill_split_plan(B, T, H, KVH, hd, page,
                                       table.shape[1], ck).ck
            sweep[took] = device_ms(call)
        finally:
            PA.PREFILL_CK = base
    # library yardstick: SDPA over a gathered (dequantized) copy, made
    # outside the timed call
    S = table.shape[1] * page
    kg = torch.repeat_interleave(
        kd[table.long()].reshape(B, S, KVH, hd), H // KVH, dim=2) \
        .transpose(1, 2).contiguous()
    vg = torch.repeat_interleave(
        vd[table.long()].reshape(B, S, KVH, hd), H // KVH, dim=2) \
        .transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=dev)[None, None, :] <=
            (qo.long()[:, None] + torch.arange(T, device=dev))[:, :, None])
    mask = mask[:, None]
    return {
        "kernel": "paged_prefill_attention", "T": T, "page": page,
        **({"kv": "int8"} if int8 else {}),
        "shape": {"q": list(q.shape), "pool": list(kp.shape),
                  "q_offset": q_offset.tolist(), "valid": valid.tolist()},
        "plan": {"ck": plan.ck, "nsplit": plan.nsplit, "gc": plan.gc,
                 "row_tiles": plan.row_tiles},
        "lanes": ["stream" if H // KVH * int(n) <= plan.gc else "tile"
                  for n in valid],
        "padding_rows_zero": True, "bitwise_deterministic": True,
        "max_abs_err": err, "kernel_ms": kernel_ms,
        "device_ms": device_ms(call), "ck_sweep_device_ms": sweep,
        "plain_ms": time_ms(lambda: paged_prefill_attention_ref(*args,
                                                                **kw)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask)),
        "library_device_ms": device_ms(lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask)),
        "bound_ms": b_ms, "bound_by": by}


def decode_case(dtype, dev, lengths, hd=128, G=4, KVH=8, page=16,
                int8=False):
    """The paged decode kernel against `paged_attention_ref`: one query a
    slot over `lengths` cached tokens through non-contiguous table rows;
    two calls bitwise equal; the split plan; and, at Llama-3-8B's heads,
    the kernel's device time at other keys and warps a block
    (`ck_warps_sweep_device_ms`).  `int8`: its int8 lane over the int8
    pool `_quantize_kv` makes of the same inputs."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.incubate.kernels import paged_attention as PA
    from paddle_tpu_torch.incubate.kernels.paged_attention import (
        _decode_split_plan, paged_attention_kernel, paged_attention_ref)
    rng = np.random.RandomState(hd + G)
    lengths = np.asarray(lengths)
    B, H = len(lengths), KVH * G
    need = [-(-int(n) // page) for n in lengths]
    max_pages, P = max(need), 1 + sum(need)
    perm = list(rng.permutation(np.arange(1, P)))
    table = np.zeros((B, max_pages), np.int32)
    for b, n in enumerate(need):
        table[b, :n] = [perm.pop() for _ in range(n)]

    def rnd(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)) \
            .to(dev, dtype)

    tbl = torch.from_numpy(table).to(dev)
    lens = torch.from_numpy(lengths.astype(np.int32)).to(dev)
    args = (rnd(B, H, hd), rnd(P, page, KVH, hd), rnd(P, page, KVH, hd), tbl,
            lens)
    kw, kd, vd = {}, args[1], args[2]
    if int8:
        kq, vq, scales = int8_pool(args[1], args[2])
        args = (args[0], kq, vq, tbl, lens)
        kw = {"kv_scales": scales}
        kd, vd = (dequantized(x, sc, dtype) for x, sc in zip((kq, vq),
                                                             scales))

    def call():
        return paged_attention_kernel(*args, **kw)
    got = call()
    err = check_close("paged_decode_attention", got,
                      paged_attention_ref(*args, **kw), dtype,
                      INT8_BF16_TOL if int8 else BF16_TOL)
    # the split merge reads the partials in split order: the same bits on
    # every call
    if not torch.equal(got, call()):
        raise AssertionError(f"paged_decode_attention hd={hd} G={G} "
                             f"({dtype}): two calls on the same inputs "
                             f"differ")
    plan = _decode_split_plan(B, H, KVH, hd, page, max_pages, PA.DECODE_CK)
    sweep = {}
    if (hd, G, KVH) == (128, 4, 8):
        # keyed "ck x warps" by the ck the plan takes
        base_ck, base_w = PA.DECODE_CK, PA.DECODE_WARPS
        try:
            for ck in (64, 128, 256, 512):
                for warps in (4, 8):
                    PA.DECODE_CK, PA.DECODE_WARPS = ck, warps
                    took = _decode_split_plan(B, H, KVH, hd, page,
                                              max_pages, ck).ck
                    sweep[f"{took}x{warps}"] = device_ms(call)
        finally:
            PA.DECODE_CK, PA.DECODE_WARPS = base_ck, base_w
    isz = args[0].element_size()
    keys = int(lengths.sum())
    row = hd + 4 if int8 else hd * isz      # a K or V row (+ its scale)
    nbytes = 2 * keys * KVH * row + 2 * B * H * hd * isz + \
        4 * (table.size + B)
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 and not int8 else \
        H100_F32_FLOPS
    b_ms, by = bound(nbytes, 4 * H * hd * keys, peak)
    # library yardstick: SDPA with enable_gqa over a gathered (dequantized)
    # copy, made outside the timed call
    S = max_pages * page
    kg, vg = (x[tbl.long()].reshape(B, S, KVH, hd).transpose(1, 2)
              .contiguous() for x in (kd, vd))
    qt = args[0][:, :, None]
    mask = (torch.arange(S, device=dev)[None] < lens.long()[:, None])
    mask = mask[:, None, None]
    return {
        "kernel": "paged_decode_attention", "hd": hd, "G": G, "page": page,
        **({"kv": "int8"} if int8 else {}),
        "shape": {"q": [B, H, hd], "pool": list(args[1].shape),
                  "lengths": lengths.tolist()},
        "plan": {"ck": plan.ck, "nsplit": plan.nsplit, "gc": plan.gc,
                 "chunks": plan.row_tiles, "warps": PA.DECODE_WARPS},
        "bitwise_deterministic": True, "max_abs_err": err,
        "kernel_ms": time_ms(call), "device_ms": device_ms(call),
        "ck_warps_sweep_device_ms": sweep,
        "plain_ms": time_ms(lambda: paged_attention_ref(*args, **kw)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask, enable_gqa=True)),
        "library_device_ms": device_ms(lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask, enable_gqa=True)),
        "bound_ms": b_ms, "bound_by": by}


def bwd_case(dtype, dev, shape, causal):
    """The backward pair against its plain version on the plain forward's
    out and lse; times of each kernel, the pair, the plain version and
    SDPA's backward alone."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.incubate.kernels.flash_attention import (
        BWD_BODY, _delta, _flash_bwd_dkv_ref, _flash_bwd_dq_ref,
        _flash_bwd_ref, _flash_fwd_ref, flash_attention_bwd, flash_bwd_dkv,
        flash_bwd_dq)
    rng = np.random.RandomState(shape[1])
    B, S, H, D = shape
    q, k, v, g = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                  .to(dev, dtype) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    out, lse = _flash_fwd_ref(q, k, v, causal, scale)
    got = flash_attention_bwd(q, k, v, out, lse, g, causal, scale)
    ref = _flash_bwd_ref(q, k, v, out, lse, g, causal, scale)
    errs = {}
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        err = float((a.float() - r.float()).abs().max())
        top = float(r.float().abs().max())
        lim = (BWD_F32_REL * max(1.0, top) if dtype == torch.float32
               else BWD_BF16_REL * top)
        if not err <= lim:
            raise AssertionError(f"flash backward {name} {shape} {dtype}: "
                                 f"max abs err {err:.3g} > {lim:.3g}")
        errs[name] = err
    # one owner per output tile, no atomics: the same bits on every call
    again = flash_attention_bwd(q, k, v, out, lse, g, causal, scale)
    bitwise = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    if not bitwise:
        raise AssertionError(f"flash backward {shape} {dtype}: two calls on "
                             f"the same inputs differ")
    del got, ref, again
    delta = _delta(out, g).contiguous()
    isz = q.element_size()
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)   # visible (q,k)
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t = B * S * H * D * isz                     # one [B, S, H, D] tensor
    stats = B * H * S * 4                       # one [B*H, S] f32 row stat
    bounds = {                                  # (bytes, matmuls)
        "dkv": (6 * t + 2 * stats, 4), "dq": (5 * t + 2 * stats, 3),
        "pair": (8 * t + stats, 5)}
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    gt = g.transpose(1, 2).contiguous()
    rec = {"kernel": "flash_attention_bwd", "shape": list(shape),
           "causal": causal, "body": BWD_BODY[(dtype, D, False)],
           "bitwise_deterministic": bitwise, "max_abs_err": errs,
           "dkv_ms": time_ms(lambda: flash_bwd_dkv(q, k, v, g, lse, delta,
                                                   causal, scale)),
           "dq_ms": time_ms(lambda: flash_bwd_dq(q, k, v, g, lse, delta,
                                                 causal, scale)),
           "pair_ms": time_ms(lambda: flash_attention_bwd(
               q, k, v, out, lse, g, causal, scale)),
           "dkv_plain_ms": time_ms(lambda: _flash_bwd_dkv_ref(
               q, k, v, g, lse, delta, causal, scale), iters=5),
           "dq_plain_ms": time_ms(lambda: _flash_bwd_dq_ref(
               q, k, v, g, lse, delta, causal, scale), iters=5),
           "pair_plain_ms": time_ms(lambda: _flash_bwd_ref(
               q, k, v, out, lse, g, causal, scale), iters=5),
           "library_ms": time_ms(lambda: torch.autograd.grad(
               lib_out, (qt, kt, vt), gt, retain_graph=True))}
    for name, (nbytes, mm) in bounds.items():
        rec[f"{name}_bound_ms"], rec[f"{name}_bound_by"] = bound(
            nbytes, mm * 2 * pairs * D, peak)
    return rec


def rms_grad_case(dtype, dev):
    """dx, dw through the RMSNorm Function (CUDA forward) against
    autograd through `_rms_ref`, on the card."""
    import torch
    from paddle_tpu_torch.incubate.kernels.rms_norm import _rms_ref, \
        rms_norm_fused
    rng = np.random.RandomState(1)
    x, gy = (torch.from_numpy(rng.randn(1024, 4096).astype(np.float32))
             .to(dev, dtype) for _ in range(2))
    w = torch.from_numpy(rng.randn(4096).astype(np.float32)).to(dev, dtype)
    grads = []
    for fn in (rms_norm_fused, lambda a, b: _rms_ref(a, b, 1e-6)):
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(xs, ws)
        if y.grad_fn is None:
            raise AssertionError("RMSNorm output has no grad_fn")
        y.backward(gy)
        grads.append((xs.grad, ws.grad))
    errs = {n: check_close(f"rms_norm {n}", a, b, dtype)
            for n, a, b in zip(("dx", "dw"), *grads)}
    return {"kernel": "rms_norm_grad", "shape": [1024, 4096],
            "dtype": str(dtype).replace("torch.", ""), "max_abs_err": errs}


# ---------------------------------------------------------------------------
# phases 3-5: the serving engine at Llama-3-8B width
# ---------------------------------------------------------------------------

def serve(params, cfg, prompts, chunk, dev, fuse=True, eager=False,
          int8=False):
    """Warm up on one short request, build the engine and warm its
    decode-side program, zero the launch counts, serve the prompts, read
    the counts; drop the engines and check their memory is released.
    `eager`: no CUDA graphs (the engine's private comparison switch);
    `int8`: int8 weights and KV pages, page INT8_PAGE.  Returns (outputs,
    phase record)."""
    import gc

    import torch
    from paddle_tpu_torch.analysis.registry import over_budget
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.quantization import kv_page_bytes
    page = INT8_PAGE if int8 else 16
    quant = dict(weight_dtype="int8", kv_dtype="int8") if int8 else {}

    def engine():
        return LLMEngine(params, cfg, num_slots=8, page_size=page,
                         max_model_len=2048, prefill_buckets=SERVE_BUCKETS,
                         prefill_chunk=chunk, fuse=fuse, device=dev,
                         _eager=eager, **quant)

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    warm = engine()
    warm.add_request(prompts[0][:16], max_new_tokens=2)
    warm.run()
    del warm
    eng = engine()
    eng.warm_decode()
    for p in prompts:
        eng.add_request(p, max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    K.reset_launches()
    steps = []
    t0 = time.perf_counter()
    while eng.has_work:
        s = time.perf_counter()
        eng.step()
        steps.append(time.perf_counter() - s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, launches_int8 = K.launches(), K.launches_int8()
    no_composed("serve")
    outs = eng.outputs
    st = eng.stats()
    num_pages = eng.cache.num_pages
    peak = torch.cuda.max_memory_allocated(dev)
    for rid, o in outs.items():
        if o.finish_reason != "length" or len(o.token_ids) != MAX_NEW or \
                not all(0 <= t < cfg.vocab_size for t in o.token_ids):
            raise AssertionError(f"request {rid}: {o.finish_reason}, "
                                 f"{len(o.token_ids)} tokens")
    fused = st["fused_dispatches"]
    L = cfg.num_layers
    # the paged kernels' launches on the pool's lane; none on the other
    lane, other = (launches_int8, launches) if int8 else \
        (launches, launches_int8)
    paged = ("paged_prefill_attention_kernel", "paged_attention_kernel")
    if any(other[n] for n in paged):
        raise AssertionError(f"paged launches on the wrong lane: fp "
                             f"{launches}, int8 {launches_int8}")
    if fuse and (lane["paged_prefill_attention_kernel"] != L * fused or
                 fused == 0):
        raise AssertionError(f"paged attention launched {lane} times "
                             f"over {fused} fused steps (int8 {int8})")
    if not fuse:
        # one launch a layer a program: decode, chunk, bucketed prefill
        want = {"paged_attention_kernel": L * st["decode_dispatches"],
                "paged_prefill_attention_kernel": L * st["chunk_dispatches"]}
        if any(lane[n] != w for n, w in want.items()) or fused or \
                launches["flash_attention_fwd"] != \
                L * st["prefill_dispatches"] or \
                st["decode_dispatches"] != st["decode_iterations"] or \
                st["decode_dispatches"] == 0:
            raise AssertionError(f"unfused launches {launches}, int8 "
                                 f"{launches_int8}, want {want} ({st})")
    if launches["rms_norm_fused"] == 0:
        raise AssertionError("RMSNorm kernel never launched")
    if chunk is None and launches["flash_attention_fwd"] == 0:
        raise AssertionError("flash kernel never launched in bucketed mode")
    # one replay a step program dispatch (none when eager); the programs
    # within the reference's budget
    replays = 0 if eager else fused + st["decode_dispatches"] + \
        st["chunk_dispatches"]
    over = over_budget(st)
    if st["graph_replays"] != replays or st["decode_executables"] > 1 or \
            over:
        raise AssertionError(f"graph replays {st['graph_replays']}, want "
                             f"{replays}; programs over budget {over} ({st})")
    execs = {k: st[k] for k in st if k.endswith("_executables")}
    gen = sum(len(o.token_ids) for o in outs.values())
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(dev) - held
    if left > RELEASE_SLACK:
        raise AssertionError(f"the dropped engines left {left / 2**20:.1f} "
                             f"MiB allocated")
    rec = {"requests": len(outs), "prompt_lens": [int(p.size) for p in
                                                  prompts],
           "buckets": SERVE_BUCKETS if chunk is None else None,
           "graphs": not eager, "page_size": page,
           "weight_dtype": st["weight_dtype"], "kv_dtype": st["kv_dtype"],
           "kv_pool_bytes": st["kv_pool_bytes"],
           # the bf16 pool of the same geometry (pages x page bytes)
           "kv_pool_bytes_bf16": num_pages * kv_page_bytes(cfg, page),
           "generated_tokens": gen, "wall_s": wall,
           "tokens_per_s": gen / wall, "engine_steps": len(steps),
           "mean_step_ms": 1e3 * wall / len(steps),
           "median_step_ms": 1e3 * float(np.median(steps)),
           "fused_dispatches": fused,
           **{k: st[k] for k in ("decode_iterations", "decode_dispatches",
                                 "chunk_dispatches", "prefill_dispatches",
                                 "graph_replays")},
           "executables": execs, "launches": launches,
           "launches_int8": launches_int8,
           "held_gib": held / 2 ** 30, "peak_mem_gib": peak / 2 ** 30,
           "left_after_release_mib": left / 2 ** 20}
    return outs, rec


def int8_first_tokens(params, cfg, prompts, outs):
    """The bucketed int8 engine's first tokens of prompts 0 and 1 against
    the argmax of the dense `forward` over the dequantized weights (the
    table and head dequantized here, the blocks layer by layer in the
    forward), held equal where the top-2 margin exceeds 0.05."""
    import torch
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.quantization import quantize_serving_params
    qp = quantize_serving_params(params, cfg)
    dense = {k: v for k, v in qp.items()
             if not k.startswith(("wte_", "lm_head_"))}
    dense["wte"] = gpt._deq(qp["wte_q"], qp["wte_scale"], cfg.dtype)
    dense["lm_head"] = gpt._deq(qp["lm_head_q"], qp["lm_head_scale"],
                                cfg.dtype)
    checks = []
    for rid in (0, 1):
        with torch.no_grad():
            logits = gpt.forward(dense, prompts[rid][None], cfg)[0, -1]
        top2 = torch.topk(logits.float(), 2)
        margin = float(top2.values[0] - top2.values[1])
        pick, first = int(top2.indices[0]), outs[rid].token_ids[0]
        if margin > 0.05 and pick != first:
            raise AssertionError(
                f"prompt {rid}: the int8 engine's first token {first} != "
                f"the dequantized forward's argmax {pick} (margin "
                f"{margin:.3g})")
        checks.append({"prompt": rid, "engine": first, "forward": pick,
                       "margin": margin,
                       "result": "match" if pick == first else "tie"})
    del qp, dense
    torch.cuda.empty_cache()
    return checks


def agreement(a, b):
    """Greedy agreement of two runs' outputs {rid: RequestOutput}."""
    same = [a[r].token_ids == b[r].token_ids for r in a]
    tok = [x == y for r in a for x, y in zip(a[r].token_ids, b[r].token_ids)]
    return {"identical_streams": sum(same),
            "first_tokens_identical": sum(a[r].token_ids[0] ==
                                          b[r].token_ids[0] for r in a),
            "of": len(same), "token_rate": sum(tok) / len(tok)}


def decode_logits(params, cfg, prompt, dev):
    """`prefill_paged` of one prompt into a fresh pool, then one
    `decode_step_paged` on its greedy next token, against the dense
    `forward` over prompt + token."""
    import torch
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.models import gpt
    page, n = 16, len(prompt)
    pages = -(-(n + 1) // page)
    cache = gpt.init_paged_cache(cfg, 1 + pages, page, device=dev)
    table = torch.arange(1, 1 + pages, dtype=torch.int32, device=dev)[None]
    ids = np.zeros((1, -(-n // page) * page), np.int32)
    ids[0, :n] = prompt
    with torch.no_grad():
        logits, cache = gpt.prefill_paged(
            params, torch.from_numpy(ids).to(dev), cfg, cache,
            table[:, :ids.shape[1] // page],
            torch.tensor([n], dtype=torch.int32, device=dev))
        tok = int(torch.argmax(logits[0]))
        K.reset_launches()
        got, _ = gpt.decode_step_paged(
            params, torch.tensor([tok], dtype=torch.int32, device=dev), cache,
            table, torch.tensor([n], dtype=torch.int32, device=dev), cfg)
        torch.cuda.synchronize()
        launches = K.launches()["paged_attention_kernel"]
        no_composed("decode_step_paged")
        ref = gpt.forward(params, np.append(prompt, tok)[None], cfg)[0, -1]
    got, ref = got[0].float(), ref.float()
    top2 = torch.topk(ref, 2)
    margin = float(top2.values[0] - top2.values[1])
    pick, want = int(torch.argmax(got)), int(top2.indices[0])
    if margin > 0.05 and pick != want:
        raise AssertionError(f"decode_step_paged argmax {pick} != forward's "
                             f"{want} (margin {margin:.3g})")
    if launches != cfg.num_layers:
        raise AssertionError(f"decode kernel launched {launches} times in "
                             f"one decode step of {cfg.num_layers} layers")
    return {"prompt_len": n, "token": tok, "decode_argmax": pick,
            "forward_argmax": want, "margin": margin,
            "result": "match" if pick == want else "tie",
            "logits_max_abs_diff": float((got - ref).abs().max()),
            "forward_logits_max_abs": float(ref.abs().max()),
            "decode_kernel_launches": launches}


# ---------------------------------------------------------------------------
# phase 9: varlen attention
# ---------------------------------------------------------------------------

def _seg_bounds(dtype, isz, pairs, D, tokens_q, tokens_k, H):
    """Bounds of the segment forward, dkv and dq kernels: the bytes each
    moves (one [tokens, H, D] tensor is t; row stats are f32; segment ids
    int32) and the products of the pairs the mask keeps (2, 4 and 3
    matmuls of 2*D flops a pair), as for the dense kernels."""
    import torch
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    tq, tk = tokens_q * H * D * isz, tokens_k * H * D * isz
    stats, seg = tokens_q * H * 4, 4 * (tokens_q + tokens_k)
    nbytes = {"fwd": 2 * tq + 2 * tk + stats + seg,
              "dkv": 2 * tq + 4 * tk + 2 * stats + seg,
              "dq": 3 * tq + 2 * tk + 2 * stats + seg}
    mms = {"fwd": 2, "dkv": 4, "dq": 3}
    return {n: bound(nbytes[n], mms[n] * 2 * pairs * D, peak)
            for n in nbytes}


def _grad_errs(name, got, ref, dtype):
    import torch
    errs = {}
    for part, a, r in zip(("dq", "dk", "dv"), got, ref):
        err = float((a.float() - r.float()).abs().max())
        top = float(r.float().abs().max())
        lim = (BWD_F32_REL * max(1.0, top) if dtype == torch.float32
               else BWD_BF16_REL * top)
        if not err <= lim:
            raise AssertionError(f"{name} {part} ({dtype}): max abs err "
                                 f"{err:.3g} > {lim:.3g}")
        errs[part] = err
    return errs


def seg_kept_tiles(ids, causal):
    """Tiles the bf16 segment backward pair walks for one head of one
    packed row of segment ids (self-attention: S == Sk), as its producers
    judge them: dq blocks of 128 query rows over 64-key tiles, dkv blocks
    of 64 keys over 64-query tiles; a tile is kept where its [min, max] of
    ids meets the block's.  Returns the kept counts and the counts of the
    causal (or full) walk without skipping."""
    S = len(ids)

    def rng_(a, b):
        return int(ids[a:b].min()), int(ids[a:b].max())

    def walk(r0, r1, first, end):         # owned rows r0..r1 - 1
        lo, hi = rng_(r0, r1)
        kept = 0
        for t in range(first, (end + 63) // 64):
            a, b = rng_(64 * t, min(64 * t + 64, end))
            kept += b >= lo and a <= hi
        return kept, (end + 63) // 64 - first

    dq = [walk(r0, min(r0 + 128, S), 0, min(r0 + 128, S) if causal else S)
          for r0 in range(0, S, 128)]
    dkv = [walk(k0, min(k0 + 64, S), k0 // 64 if causal else 0, S)
           for k0 in range(0, S, 64)]
    return {"dq": sum(k for k, _ in dq), "dq_walk": sum(n for _, n in dq),
            "dkv": sum(k for k, _ in dkv), "dkv_walk": sum(n for _, n in dkv)}


def _packed_lengths(rng, total):
    """Segment lengths drawn in [128, 2048], the last cut to fit."""
    lens = []
    while sum(lens) < total:
        lens.append(int(rng.randint(128, 2049)))
    lens[-1] -= sum(lens) - total
    return lens


def varlen_case(dtype, dev, total=8192, H=16, D=128):
    """8192 packed tokens through `flash_attn_unpadded(causal=True)`
    forward and backward (the main path: counts zeroed before, read after),
    then held against the plain versions and timed."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.incubate.kernels.flash_attention import (
        BWD_BODY, FWD_BODY, _delta, _flash_bwd_ref, _flash_bwd_seg_dkv_ref,
        _flash_bwd_seg_dq_ref, _flash_fwd_seg_ref, flash_attention_seg_fwd,
        flash_bwd_seg_dkv, flash_bwd_seg_dq)
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded
    rng = np.random.RandomState(0)
    lens = _packed_lengths(rng, total)
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    q, k, v, g = (torch.from_numpy(rng.randn(total, H, D).astype(np.float32))
                  .to(dev, dtype) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    composed = flash_attn_unpadded.composed_calls
    torch.cuda.synchronize()
    K.reset_launches()
    out, _ = flash_attn_unpadded(*ts, cu, cu, max(lens), max(lens), scale,
                                 causal=True)
    out.backward(g)
    torch.cuda.synchronize()
    launches = K.launches()
    no_composed("varlen")
    if flash_attn_unpadded.composed_calls != composed:
        raise AssertionError("flash_attn_unpadded took its composed route")
    if (launches["flash_attention_seg_fwd"], launches["flash_bwd_seg_dkv"],
            launches["flash_bwd_seg_dq"]) != (1, 1, 1):
        raise AssertionError(f"varlen launches {launches}")
    seg = torch.from_numpy(np.repeat(np.arange(len(lens)), lens)
                           .astype(np.int32)).to(dev)[None]
    q4, k4, v4, g4 = (x[None] for x in (q, k, v, g))
    ref_out, ref_lse = _flash_fwd_seg_ref(q4, k4, v4, seg, seg, True, scale)
    err = check_close("flash_attention_seg_fwd", out.detach()[None], ref_out,
                      dtype)
    ref = _flash_bwd_ref(q4, k4, v4, ref_out, ref_lse, g4, True, scale,
                         seg=(seg, seg))
    errs = _grad_errs("varlen backward", [t.grad[None] for t in ts], ref,
                      dtype)
    del ref, ts, out
    torch.cuda.empty_cache()
    # times of each kernel and its plain version on the same inputs
    o, lse = flash_attention_seg_fwd(q4, k4, v4, seg, seg, True, scale)
    delta = _delta(o, g4).contiguous()
    bwd = (q4, k4, v4, g4, lse, delta, seg, seg, True, scale)
    # one owner per output tile, no atomics: the same bits on every call
    first, again = ((flash_bwd_seg_dq(*bwd), *flash_bwd_seg_dkv(*bwd))
                    for _ in range(2))
    if not all(bool(torch.equal(a, b)) for a, b in zip(first, again)):
        raise AssertionError(f"varlen backward ({dtype}): two calls on the "
                             f"same inputs differ")
    del first, again
    pairs = H * sum(n * (n + 1) // 2 for n in lens)
    bounds = _seg_bounds(dtype, q.element_size(), pairs, D, total, total, H)
    kept = seg_kept_tiles(np.repeat(np.arange(len(lens)), lens), True)
    rec = {"kernel": "flash_attention_varlen", "tokens": total, "H": H,
           "D": D, "segments": lens, "fwd_body": FWD_BODY[dtype],
           "bwd_body": BWD_BODY[(dtype, D, True)],
           "bwd_bitwise_deterministic": True,
           "bwd_tiles_per_head": kept, "launches": launches,
           "max_abs_err": {"out": err, **errs},
           "fwd_ms": time_ms(lambda: flash_attention_seg_fwd(
               q4, k4, v4, seg, seg, True, scale), iters=5),
           "dkv_ms": time_ms(lambda: flash_bwd_seg_dkv(*bwd), iters=5),
           "dq_ms": time_ms(lambda: flash_bwd_seg_dq(*bwd), iters=5),
           "fwd_plain_ms": time_ms(lambda: _flash_fwd_seg_ref(
               q4, k4, v4, seg, seg, True, scale), iters=2, warmup=1),
           "dkv_plain_ms": time_ms(lambda: _flash_bwd_seg_dkv_ref(*bwd),
                                   iters=2, warmup=1),
           "dq_plain_ms": time_ms(lambda: _flash_bwd_seg_dq_ref(*bwd),
                                  iters=2, warmup=1)}
    for n, (b_ms, by) in bounds.items():
        rec[f"{n}_bound_ms"], rec[f"{n}_bound_by"] = b_ms, by
    del bwd, o, lse, delta
    torch.cuda.empty_cache()
    # library yardstick: SDPA under the boolean block-diagonal mask
    mask = seg[0][:, None] == seg[0][None, :]
    mask = mask & torch.ones(total, total, dtype=torch.bool,
                             device=dev).tril()
    qt, kt, vt = (x.transpose(0, 1)[None].contiguous().requires_grad_()
                  for x in (q, k, v))
    gt = g.transpose(0, 1)[None].contiguous()
    rec["sdpa_fwd_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), iters=5)
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    rec["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), gt, retain_graph=True), iters=5)

    def fwd_bwd():
        o_ = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
        torch.autograd.grad(o_, (qt, kt, vt), gt)
    rec["sdpa_fwd_bwd_ms"] = time_ms(fwd_bwd, iters=5)
    del lib_out, qt, kt, vt, gt, mask
    torch.cuda.empty_cache()
    return rec


def varlen_cross_case(dtype, dev, total=4096, H=16, D=128):
    """Non-causal `flash_attn_unpadded` with key offsets other than the
    query offsets (the kernel route; rows whose sequence has no key would
    give 0), against the plain version."""
    import torch
    from paddle_tpu_torch.incubate.kernels.flash_attention import \
        _flash_fwd_seg_ref
    from paddle_tpu_torch.nn.functional import flash_attn_unpadded
    rng = np.random.RandomState(1)
    lq = _packed_lengths(rng, total)
    lk = [int(rng.randint(64, 1025)) for _ in lq]
    cq = np.concatenate([[0], np.cumsum(lq)]).astype(np.int32)
    ck = np.concatenate([[0], np.cumsum(lk)]).astype(np.int32)
    q = torch.from_numpy(rng.randn(cq[-1], H, D).astype(np.float32)) \
        .to(dev, dtype)
    k, v = (torch.from_numpy(rng.randn(ck[-1], H, D).astype(np.float32))
            .to(dev, dtype) for _ in range(2))
    composed = flash_attn_unpadded.composed_calls
    out, _ = flash_attn_unpadded(q, k, v, cq, ck, max(lq), max(lk), 0.088,
                                 causal=False)
    if flash_attn_unpadded.composed_calls != composed:
        raise AssertionError("non-causal cross layout took the composed route")
    sq, sk = (torch.from_numpy(np.repeat(np.arange(len(x)), x)
                               .astype(np.int32)).to(dev)[None]
              for x in (lq, lk))
    ref, _ = _flash_fwd_seg_ref(q[None], k[None], v[None], sq, sk, False,
                                0.088)
    return {"kernel": "flash_attn_unpadded", "causal": False,
            "q_tokens": int(cq[-1]), "k_tokens": int(ck[-1]),
            "segments": len(lq),
            "max_abs_err": check_close("varlen non-causal", out[None], ref,
                                       dtype)}


def segment_ids_case(dtype, dev, shape=(4, 2048, 16, 128)):
    """`flash_attention(segment_ids=, causal=True)` forward and backward at
    the training shape with 1-4 segments a row, against the plain versions;
    the dense kernels' times on the same tensors beside it."""
    import torch
    from paddle_tpu_torch.incubate.kernels.flash_attention import (
        FWD_BODY, _flash_bwd_ref, _flash_fwd_seg_ref, flash_attention_fwd,
        flash_attention_seg_fwd)
    from paddle_tpu_torch.nn.functional import flash_attention
    rng = np.random.RandomState(2)
    B, S, H, D = shape
    ids = np.zeros((B, S), np.int32)
    for b in range(B):
        cuts = np.sort(rng.choice(np.arange(1, S), b, replace=False))
        ids[b] = np.searchsorted(cuts, np.arange(S), side="right")
    seg = torch.from_numpy(ids).to(dev)
    q, k, v, g = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                  .to(dev, dtype) for _ in range(4))
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    out, none = flash_attention(*ts, causal=True, segment_ids=seg)
    out.backward(g)
    scale = 1.0 / math.sqrt(D)
    ref_out, ref_lse = _flash_fwd_seg_ref(q, k, v, seg, seg, True, scale)
    err = check_close("flash_attention(segment_ids=)", out.detach(), ref_out,
                      dtype)
    errs = _grad_errs("segment_ids backward", [t.grad for t in ts],
                      _flash_bwd_ref(q, k, v, ref_out, ref_lse, g, True,
                                     scale, seg=(seg, seg)), dtype)
    rec = {"kernel": "flash_attention(segment_ids=)", "shape": list(shape),
           "segments_per_row": [b + 1 for b in range(B)],
           "fwd_body": FWD_BODY[dtype],
           "max_abs_err": {"out": err, **errs},
           "seg_fwd_ms": time_ms(lambda: flash_attention_seg_fwd(
               q, k, v, seg, seg, True, scale), iters=5),
           "dense_fwd_ms": time_ms(lambda: flash_attention_fwd(
               q, k, v, True, scale), iters=5)}
    del ts, out
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phases 10-11: the trainer
# ---------------------------------------------------------------------------

def train_parity(dev):
    """loss_fn and its grads through the kernels vs `attn_impl=
    attention_ref`, float32 (TF32 is off), Llama-3-8B width, 2 layers."""
    import torch
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.incubate.kernels.flash_attention import \
        attention_ref
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel.hybrid import _leaves
    cfg = gpt.llama3_8b()
    cfg.num_layers = 2
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                             dev)
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_()
    rng = np.random.RandomState(1)
    tok = rng.randint(0, cfg.vocab_size, (1, 1024))
    lab = np.roll(tok, -1, axis=1)
    runs, launches = [], None
    for impl in (None, lambda q, k, v: attention_ref(q, k, v, causal=True)):
        torch.cuda.synchronize()
        K.reset_launches()
        loss = gpt.loss_fn(params, tok, lab, cfg, remat=True, attn_impl=impl)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        torch.cuda.synchronize()
        if impl is None:
            launches = K.launches()
            no_composed("train_parity")
        runs.append((loss.item(), grads))
        del loss
    (lk, gk), (lr, gr) = runs
    rel = abs(lk - lr) / abs(lr)
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(gk, gr) if float(b.abs().max()) > 0)
    if not (math.isfinite(lk) and rel <= 1e-4 and worst <= 1e-3):
        raise AssertionError(f"train_parity: loss {lk} vs {lr} (rel {rel:.3g})"
                             f", worst grad leaf {worst:.3g}")
    if (launches["flash_attention_fwd"], launches["flash_bwd_dkv"],
            launches["flash_bwd_dq"]) != (2, 2, 2) or \
            launches["rms_norm_fused"] == 0:
        raise AssertionError(f"train_parity launches {launches}")
    return {"model": "llama3_8b", "layers": 2, "dtype": "float32",
            "batch": [1, 1024], "loss_kernels": lk, "loss_plain": lr,
            "loss_rel_diff": rel, "worst_grad_leaf_rel_err": worst,
            "grad_leaves": len(gk), "launches": launches}


def train(dev):
    """GPT-3 1.3B through the trainer: 1 warm-up + 4 timed steps."""
    import torch
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import HybridParallelTrainer, MeshConfig
    cfg = gpt.gpt3_1p3b()
    cfg.dtype = torch.bfloat16
    B, S, steps = 4, 2048, 4
    trainer = HybridParallelTrainer(cfg, MeshConfig(remat=True),
                                    moment_dtype=torch.bfloat16, device=dev)
    rng = np.random.RandomState(0)
    tok = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1).astype(np.int32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    K.reset_launches()
    losses = [float(trainer.train_step(tok, lab))]          # warm-up
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(tok, lab)))  # syncs
        times.append(time.perf_counter() - t0)
    launches = K.launches()
    no_composed("train")
    per_step = {k: v / (steps + 1) for k, v in launches.items()}
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: non-finite loss {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
        raise AssertionError(f"train: step-0 loss {losses[0]} is not near "
                             f"ln(V) = {math.log(cfg.vocab_size):.3f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall {losses}")
    want = cfg.num_layers * (steps + 1)
    for name in ("flash_attention_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        if launches[name] != want:
            raise AssertionError(f"train: {name} launched {launches[name]} "
                                 f"times, want {want}")
    return {"model": "gpt3_1p3b", "layers": cfg.num_layers, "dtype": "bf16",
            "moments": "bf16", "remat": True, "batch": [B, S],
            "params": gpt.count_params(trainer.params),
            "tokens_per_s": B * S * steps / sum(times),
            "mean_step_ms": 1e3 * sum(times) / steps,
            "median_step_ms": 1e3 * float(np.median(times)),
            "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "losses": losses, "launches": launches,
            "launches_per_step": per_step}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from paddle_tpu_torch.incubate.kernels import _cuda
    from paddle_tpu_torch.models import gpt

    t = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    reports = _cuda.build_all()
    ptxas = {k: [ln.strip() for ln in log.splitlines() if "Used" in ln
                 or "spill" in ln or "Performance Loss" in ln]
             for k, (_, log) in reports.items()}
    bwd_wgmma = [row for src in ("flash_attention_bwd",
                                 "flash_attention_seg_bwd")
                 for row in ptxas_kernels(reports.get(src, (0, ""))[1],
                                          "wgmma")]
    no_spills(bwd_wgmma)
    # the prefill kernel: 4 (q, pool) dtype pairs (f32/f32, bf16/bf16,
    # f32/int8, bf16/int8) x 3 head dims x 4 GC
    paged = ptxas_kernels(reports.get("paged_attention", (0, ""))[1],
                          "paged_prefill_kernel")
    if "paged_attention" in reports and len(paged) != 48:
        raise AssertionError(f"ptxas reports {len(paged)} paged prefill "
                             f"kernels, want 48")
    no_spills(paged)
    # the decode kernel: 4 (q, pool) dtype pairs x 3 head dims x 4 GC x 2
    # warp counts; RMSNorm's register kernel: 4 dtype pairs x 2 piece widths
    # x 5 register depths; its ring kernel: 4 dtype pairs
    more = {}
    for src, kern, want in (("paged_decode", "paged_decode_kernel", 96),
                            ("rms_norm", "rms_kernel", 40),
                            ("rms_norm", "rms_tma_kernel", 4)):
        more[kern] = ptxas_kernels(reports.get(src, (0, ""))[1], kern)
        if src in reports and len(more[kern]) != want:
            raise AssertionError(f"ptxas reports {len(more[kern])} {kern} "
                                 f"instantiations, want {want}")
        no_spills(more[kern])
    emit({"phase": "device", "seconds": time.perf_counter() - t,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "built_s": {k: sec for k, (sec, _) in reports.items()},
          "ptxas": ptxas, "ptxas_bwd_wgmma": bwd_wgmma,
          "ptxas_paged_prefill": paged,
          "ptxas_paged_decode": more["paged_decode_kernel"],
          "ptxas_rms_norm": more["rms_kernel"] + more["rms_tma_kernel"]})

    t = time.perf_counter()
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        # RMSNorm at the fused bucketed step's [8, 4096], the chunked
        # step's [128, 4096] (B 8, T 16) and a prefill-sized [4096, 4096]
        rows = [{**rms_case(dtype, dev, N),
                 **(rms_launch_sweep(dtype, dev, N) if N != 128 else {})}
                for N in (4096, 8, 128)]
        rows += [flash_case(dtype, dev, shape) for shape in
                 ((1, 16, 32, 128), (1, 1024, 32, 128), (4, 2048, 16, 128))]
        rows += [paged_case(dtype, dev, T) for T in (1, 16)]
        # decode: the smoke prompts' lengths at Llama-3-8B's heads, then
        # hd 64 and 256 at G 1 and 8 with lengths ending mid-page
        rows.append(decode_case(dtype, dev, PROMPT_LENS))
        rows += [decode_case(dtype, dev, (37, 1000, 16, 1), hd=hd, G=G,
                             KVH=4) for hd in (64, 256) for G in (1, 8)]
        # the int8 lanes at the same serving shapes, page 16 and 32
        for page in (16, INT8_PAGE):
            rows += [paged_case(dtype, dev, T, page, int8=True)
                     for T in (1, 16)]
            rows.append(decode_case(dtype, dev, PROMPT_LENS, page=page,
                                    int8=True))
        for r in rows:
            r["dtype"] = str(dtype).replace("torch.", "")
        results += rows
    emit({"phase": "kernels", "seconds": time.perf_counter() - t,
          "results": results})

    t = time.perf_counter()
    cfg = gpt.llama3_8b()
    cfg.dtype = torch.bfloat16
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    bucketed, rec3 = serve(params, cfg, prompts, None, dev)
    emit({"phase": "engine_bucketed", "seconds": time.perf_counter() - t,
          "model": "llama3_8b", "layers": cfg.num_layers, "dtype": "bf16",
          **rec3})

    t = time.perf_counter()
    chunked, rec4 = serve(params, cfg, prompts, 16, dev)
    emit({"phase": "engine_chunked", "seconds": time.perf_counter() - t,
          "prefill_chunk": 16, **rec4,
          "greedy_agreement": agreement(bucketed, chunked)})

    t = time.perf_counter()
    unfused, rec5 = {}, {}
    for mode, chunk, fused_outs in (("bucketed", None, bucketed),
                                    ("chunked", 16, chunked)):
        unfused[mode], rec5[mode] = serve(params, cfg, prompts, chunk, dev,
                                          fuse=False)
        rec5[mode]["greedy_agreement_with_fused"] = agreement(fused_outs,
                                                              unfused[mode])
    emit({"phase": "engine_unfused", "seconds": time.perf_counter() - t,
          "fuse": False, **rec5})

    t = time.perf_counter()
    rec6 = {}
    keys = ("tokens_per_s", "median_step_ms", "mean_step_ms", "peak_mem_gib",
            "graph_replays", "executables")
    for mode, chunk, outs, rec in (("bucketed", None, bucketed, rec3),
                                   ("chunked", 16, chunked, rec4)):
        eager, erec = serve(params, cfg, prompts, chunk, dev, eager=True)
        agree = agreement(outs, eager)
        if agree["identical_streams"] != agree["of"]:
            raise AssertionError(f"engine_graphs {mode}: graph and eager "
                                 f"streams differ {agree}")
        if erec["launches"] != rec["launches"]:
            raise AssertionError(f"engine_graphs {mode}: launches "
                                 f"{rec['launches']} on graphs, "
                                 f"{erec['launches']} eager")
        rec6[mode] = {"graphs": {k: rec[k] for k in keys},
                      "eager": {k: erec[k] for k in keys},
                      "agreement": agree, "launches_equal": True}
    emit({"phase": "engine_graphs", "seconds": time.perf_counter() - t,
          **rec6})

    t = time.perf_counter()
    int8_runs, rec_q = {}, {}
    for mode, chunk, fuse, bf16_outs in (
            ("bucketed", None, True, bucketed),
            ("chunked", 16, True, chunked),
            ("unfused_bucketed", None, False, unfused["bucketed"])):
        int8_runs[mode], rec_q[mode] = serve(params, cfg, prompts, chunk,
                                             dev, fuse=fuse, int8=True)
        rec_q[mode]["greedy_agreement_with_bf16"] = agreement(
            bf16_outs, int8_runs[mode])
    emit({"phase": "engine_int8", "seconds": time.perf_counter() - t,
          "page_size": INT8_PAGE, **rec_q,
          "first_token": int8_first_tokens(params, cfg, prompts,
                                           int8_runs["bucketed"])})

    t = time.perf_counter()
    checks = []
    modes = (("bucketed", bucketed), ("chunked", chunked),
             ("unfused_bucketed", unfused["bucketed"]),
             ("unfused_chunked", unfused["chunked"]))
    for rid in (0, 1):
        with torch.no_grad():
            logits = gpt.forward(params, prompts[rid][None], cfg)[0, -1]
        top2 = torch.topk(logits.float(), 2)
        margin = float(top2.values[0] - top2.values[1])
        pick = int(top2.indices[0])
        for mode, outs in modes:
            first = outs[rid].token_ids[0]
            if margin > 0.05 and pick != first:
                raise AssertionError(
                    f"prompt {rid}: {mode} engine's first token {first} != "
                    f"forward argmax {pick} (margin {margin:.3g})")
            checks.append({"prompt": rid, "mode": mode, "engine": first,
                           "forward": pick, "margin": margin,
                           "result": "match" if pick == first else "tie"})
    emit({"phase": "first_token", "seconds": time.perf_counter() - t,
          "checks": checks})

    t = time.perf_counter()
    rec = decode_logits(params, cfg, prompts[0], dev)
    emit({"phase": "decode_logits", "seconds": time.perf_counter() - t,
          **rec})
    del params
    torch.cuda.empty_cache()

    t = time.perf_counter()
    bwd = []
    for dtype in (torch.bfloat16, torch.float32):
        for shape, causal in (((1, 1024, 32, 128), True),
                              ((4, 2048, 16, 128), True),
                              ((2, 333, 8, 64), False)):
            r = bwd_case(dtype, dev, shape, causal)
            r["dtype"] = str(dtype).replace("torch.", "")
            bwd.append(r)
            torch.cuda.empty_cache()
    rms_grads = [rms_grad_case(d, dev) for d in (torch.bfloat16,
                                                 torch.float32)]
    emit({"phase": "kernels_bwd", "seconds": time.perf_counter() - t,
          "results": bwd, "rms_norm_grad": rms_grads})

    t = time.perf_counter()
    varlen = [varlen_case(d, dev) for d in (torch.bfloat16, torch.float32)]
    for r, d in zip(varlen, ("bfloat16", "float32")):
        r["dtype"] = d
    extra = [f(d, dev) for d in (torch.bfloat16, torch.float32)
             for f in (varlen_cross_case, segment_ids_case)]
    rec9 = {"launches": {n: sum(r["launches"][n] for r in varlen)
                         for n in varlen[0]["launches"]}}
    emit({"phase": "varlen", "seconds": time.perf_counter() - t,
          "results": varlen, "more": extra})

    t = time.perf_counter()
    rec7 = train_parity(dev)
    torch.cuda.empty_cache()
    emit({"phase": "train_parity", "seconds": time.perf_counter() - t,
          **rec7})

    t = time.perf_counter()
    rec8 = train(dev)
    emit({"phase": "train", "seconds": time.perf_counter() - t, **rec8})

    def main_shape(kernel, **match):
        return next(r for r in results
                    if r["kernel"] == kernel and r["dtype"] == "bfloat16"
                    and all(r.get(k) == v for k, v in match.items()))

    train_bwd = next(r for r in bwd if r["dtype"] == "bfloat16" and
                     r["shape"] == [4, 2048, 16, 128])

    def bwd_row(part, errs):
        # the library yardstick is the pair's: SDPA's backward computes
        # dq, dk and dv in one call
        return {"kernel": f"flash_attention_bwd_{part}",
                "body": train_bwd["body"],
                "max_abs_err": max(train_bwd["max_abs_err"][e]
                                   for e in errs),
                "kernel_ms": train_bwd[f"{part}_ms"],
                "plain_ms": train_bwd[f"{part}_plain_ms"],
                "library_ms": train_bwd["library_ms"],
                "bound_ms": train_bwd[f"{part}_bound_ms"],
                "bound_by": train_bwd[f"{part}_bound_by"]}

    # (result row at the main path's bf16 shape, counter, route, source,
    #  replaced TPU kernel)
    vl = next(r for r in varlen if r["dtype"] == "bfloat16")

    def seg_row(part, errs):
        # library yardsticks: SDPA forward, and SDPA's backward alone (it
        # computes dq, dk and dv together), under the block-diagonal mask
        return {"kernel": "flash_attention_seg_" +
                          (part if part == "fwd" else f"bwd_{part}"),
                "body": vl["fwd_body" if part == "fwd" else "bwd_body"],
                "max_abs_err": max(vl["max_abs_err"][e] for e in errs),
                "kernel_ms": vl[f"{part}_ms"],
                "plain_ms": vl[f"{part}_plain_ms"],
                "library_ms": vl["sdpa_fwd_ms" if part == "fwd"
                                 else "sdpa_bwd_ms"],
                "bound_ms": vl[f"{part}_bound_ms"],
                "bound_by": vl[f"{part}_bound_by"]}

    table = (
        (main_shape("paged_prefill_attention", T=1, kv=None),
         "paged_prefill_attention_kernel", "cuda",
         "paddle_tpu_torch/csrc/paged_attention.cu",
         "paddle_tpu/incubate/kernels/paged_attention.py:411"),
        (main_shape("flash_attention_fwd", S=1024), "flash_attention_fwd",
         "cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
         "paddle_tpu/incubate/kernels/flash_attention.py:78"),
        (main_shape("rms_norm", shape=[4096, 4096]), "rms_norm_fused",
         "cuda", "paddle_tpu_torch/csrc/rms_norm.cu",
         "paddle_tpu/incubate/kernels/rms_norm.py:15"),
        (bwd_row("dkv", ("dk", "dv")), "flash_bwd_dkv", "cuda",
         "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
         "paddle_tpu/incubate/kernels/flash_attention.py:195"),
        (bwd_row("dq", ("dq",)), "flash_bwd_dq", "cuda",
         "paddle_tpu_torch/csrc/flash_attention_bwd.cu",
         "paddle_tpu/incubate/kernels/flash_attention.py:241"),
        (main_shape("paged_decode_attention", hd=128, G=4, kv=None),
         "paged_attention_kernel", "cuda",
         "paddle_tpu_torch/csrc/paged_decode.cu",
         "paddle_tpu/incubate/kernels/paged_attention.py:247"),
        (seg_row("fwd", ("out",)), "flash_attention_seg_fwd", "cuda",
         "paddle_tpu_torch/csrc/flash_attention.cu",
         "paddle_tpu/incubate/kernels/flash_attention.py:439"),
        (seg_row("dkv", ("dk", "dv")), "flash_bwd_seg_dkv", "cuda",
         "paddle_tpu_torch/csrc/flash_attention_seg_bwd.cu",
         "paddle_tpu/incubate/kernels/flash_attention.py:487"),
        (seg_row("dq", ("dq",)), "flash_bwd_seg_dq", "cuda",
         "paddle_tpu_torch/csrc/flash_attention_seg_bwd.cu",
         "paddle_tpu/incubate/kernels/flash_attention.py:530"),
    )
    # the int8 lanes (launches_int8), at the int8 engines' page
    table_int8 = (
        (main_shape("paged_prefill_attention", T=1, kv="int8",
                    page=INT8_PAGE),
         "paged_prefill_attention_kernel", "cuda",
         "paddle_tpu_torch/csrc/paged_attention.cu",
         "paddle_tpu/incubate/kernels/paged_attention.py:411"),
        (main_shape("paged_decode_attention", kv="int8", page=INT8_PAGE),
         "paged_attention_kernel", "cuda",
         "paddle_tpu_torch/csrc/paged_decode.cu",
         "paddle_tpu/incubate/kernels/paged_attention.py:247"),
    )
    runs = (rec3, rec4, rec5["bucketed"], rec5["chunked"], *rec_q.values(),
            rec9, rec7, rec8)
    kernels = [{
        "name": r["kernel"] + ("_int8" if key == "launches_int8" else ""),
        "route": route, "source": source, "replaces": replaces,
        "launches": sum(rec.get(key, {}).get(counter, 0) for rec in runs),
        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        **({"body": r["body"]} if "body" in r else {})}
        for rows, key in ((table, "launches"), (table_int8, "launches_int8"))
        for r, counter, route, source, replaces in rows]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
