#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each (with its seconds):
1. device   — requires CUDA, prints the card's name and power limit,
               disables TF32 for the float32 references, builds the CUDA
               kernels (one nvcc per source, in parallel).
2. kernels  — each hand-written kernel against its plain PyTorch version on
               the same numpy-seeded inputs at the serving shapes, in bf16
               and float32: max abs error (valid rows only for paged
               attention), kernel/plain/library times (CUDA events).
3. engine_bucketed — Llama-3-8B at full width (all 32 layers), bf16, random
               weights from a seeded generator, 8 greedy requests of 64-1024
               prompt tokens x 32 new tokens through `LLMEngine` with
               one-shot bucketed prefill; launch counts are zeroed just before
               and read just after.
4. engine_chunked  — the same requests with `prefill_chunk=16`, the chunk
               riding the fused step; greedy agreement with phase 3 printed.
5. first_token — phases 3 and 4's first tokens for two prompts against the
               argmax of the dense `forward` at the last prompt position,
               held equal where the top-2 margin exceeds 0.05 (ties printed).

Then one line `{"kernels": [...]}` and, last, `{"ok": true, "device": ...}`.
Exits non-zero, with no result line, without CUDA, outside the repository,
or when any phase fails.
"""
import json
import math
import subprocess
import sys
import time

import numpy as np

BF16_TOL = dict(atol=2e-2, rtol=2e-2)   # bf16 rounding of P before PV
F32_TOL = 1e-4                          # same math, other summation order
H100_BYTES_S = 3.35e12                  # HBM3, NVIDIA data sheet (SXM)
H100_BF16_FLOPS = 989e12                # dense tensor-core bf16
H100_F32_FLOPS = 67e12                  # float32 outside the tensor cores
MAX_NEW = 32
PROMPT_LENS = (64, 96, 160, 256, 384, 512, 768, 1024)


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


def bound(nbytes, flops, peak_flops):
    t_bytes = nbytes / H100_BYTES_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def check_close(name, got, ref, dtype):
    import torch
    err = float((got.float() - ref.float()).abs().max())
    if dtype == torch.float32:
        ok = err <= F32_TOL
    else:
        ok = bool(torch.allclose(got.float(), ref.float(), **BF16_TOL))
    if not ok:
        raise AssertionError(f"{name} ({dtype}): kernel disagrees with its "
                             f"plain version, max abs err {err:.3g}")
    return err


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def rms_case(dtype, dev):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.incubate.kernels.rms_norm import _rms_ref, \
        rms_norm_fused
    rng = np.random.RandomState(0)
    N, D = 4096, 4096
    x = torch.from_numpy(rng.randn(N, D).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy(rng.randn(D).astype(np.float32)).to(dev, dtype)
    got = rms_norm_fused(x, w)
    ref = _rms_ref(x, w, 1e-6)
    isz = x.element_size()
    b, by = bound((2 * N * D + D) * isz, 4 * N * D, H100_F32_FLOPS)
    return {
        "kernel": "rms_norm", "shape": [N, D],
        "max_abs_err": check_close("rms_norm", got, ref, dtype),
        "kernel_ms": time_ms(lambda: rms_norm_fused(x, w)),
        "plain_ms": time_ms(lambda: _rms_ref(x, w, 1e-6)),
        "library_ms": time_ms(lambda: F.rms_norm(x, (D,), w, 1e-6)),
        "bound_ms": b, "bound_by": by}


def flash_case(dtype, dev, S):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.incubate.kernels.flash_attention import (
        _flash_fwd_ref, flash_attention_fwd)
    rng = np.random.RandomState(S)
    B, H, D = 1, 32, 128
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
        "max_abs_err": err, "lse_max_abs_err": lse_err,
        "kernel_ms": time_ms(lambda: flash_attention_fwd(q, k, v, True,
                                                         scale)),
        "plain_ms": time_ms(lambda: _flash_fwd_ref(q, k, v, True, scale)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)),
        "bound_ms": b, "bound_by": by}


def paged_inputs(dtype, dev, T):
    """B=8, page 16, H=32, KVH=8, hd=128, max_pages 128 (2048 tokens), mixed
    q_offset/valid; slots 6 and 7 are null-table slots (valid 1, offset 0)."""
    import torch
    rng = np.random.RandomState(T)
    B, H, KVH, hd, page, max_pages = 8, 32, 8, 128, 16, 128
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


def paged_case(dtype, dev, T):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.incubate.kernels.paged_attention import (
        paged_prefill_attention_kernel, paged_prefill_attention_ref)
    args, q_offset, valid = paged_inputs(dtype, dev, T)
    got = paged_prefill_attention_kernel(*args)
    ref = paged_prefill_attention_ref(*args)
    err = max(check_close("paged_attention", got[b, :n], ref[b, :n], dtype)
              for b, n in enumerate(valid))
    q, kp, vp, table, qo, vl = args
    B, _, H, hd = q.shape
    P, page, KVH, _ = kp.shape
    isz = q.element_size()
    # what this data needs: each slot's keys up to its last real query,
    # each valid row's causal span
    keys = sum(int(q_offset[b] + valid[b]) for b in range(B))
    nbytes = (2 * B * T * H * hd * isz + 2 * keys * KVH * hd * isz
              + table.numel() * 4 + 2 * B * 4)
    flops = sum(4 * H * hd * (int(q_offset[b]) + t + 1)
                for b in range(B) for t in range(int(valid[b])))
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    b_ms, by = bound(nbytes, flops, peak)
    # library yardstick: SDPA over a gathered copy (the gather is not timed)
    S = table.shape[1] * page
    kg = torch.repeat_interleave(
        kp[table.long()].reshape(B, S, KVH, hd), H // KVH, dim=2) \
        .transpose(1, 2).contiguous()
    vg = torch.repeat_interleave(
        vp[table.long()].reshape(B, S, KVH, hd), H // KVH, dim=2) \
        .transpose(1, 2).contiguous()
    qt = q.transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=dev)[None, None, :] <=
            (qo.long()[:, None] + torch.arange(T, device=dev))[:, :, None])
    mask = mask[:, None]
    return {
        "kernel": "paged_prefill_attention", "T": T,
        "shape": {"q": list(q.shape), "pool": list(kp.shape),
                  "q_offset": q_offset.tolist(), "valid": valid.tolist()},
        "max_abs_err": err,
        "kernel_ms": time_ms(lambda: paged_prefill_attention_kernel(*args)),
        "plain_ms": time_ms(lambda: paged_prefill_attention_ref(*args)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask)),
        "bound_ms": b_ms, "bound_by": by}


# ---------------------------------------------------------------------------
# phases 3-5: the serving engine at Llama-3-8B width
# ---------------------------------------------------------------------------

def serve(params, cfg, prompts, chunk, dev):
    """Warm up on one short request, zero the launch counts, serve the
    prompts, read the counts.  Returns (outputs, phase record)."""
    import torch
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.inference.engine import LLMEngine

    def engine():
        return LLMEngine(params, cfg, num_slots=8, page_size=16,
                         max_model_len=2048, prefill_chunk=chunk, device=dev)

    warm = engine()
    warm.add_request(prompts[0][:16], max_new_tokens=2)
    warm.run()
    eng = engine()
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
    launches = K.launches()
    outs = eng.outputs
    st = eng.stats()
    for rid, o in outs.items():
        if o.finish_reason != "length" or len(o.token_ids) != MAX_NEW or \
                not all(0 <= t < cfg.vocab_size for t in o.token_ids):
            raise AssertionError(f"request {rid}: {o.finish_reason}, "
                                 f"{len(o.token_ids)} tokens")
    fused = st["fused_dispatches"]
    if launches["paged_prefill_attention_kernel"] < cfg.num_layers * fused \
            or fused == 0:
        raise AssertionError(f"paged attention launched {launches} times "
                             f"over {fused} fused steps")
    if launches["rms_norm_fused"] == 0:
        raise AssertionError("RMSNorm kernel never launched")
    if chunk is None and launches["flash_attention_fwd"] == 0:
        raise AssertionError("flash kernel never launched in bucketed mode")
    gen = sum(len(o.token_ids) for o in outs.values())
    rec = {"requests": len(outs), "prompt_lens": [int(p.size) for p in
                                                  prompts],
           "generated_tokens": gen, "wall_s": wall,
           "tokens_per_s": gen / wall, "engine_steps": len(steps),
           "mean_step_ms": 1e3 * wall / len(steps),
           "median_step_ms": 1e3 * float(np.median(steps)),
           "fused_dispatches": fused, "launches": launches,
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    return outs, rec


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
    ptxas = {k: [ln.strip() for ln in v.splitlines() if "Used" in ln
                 or "spill" in ln] for k, v in reports.items()}
    emit({"phase": "device", "seconds": time.perf_counter() - t,
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "built": sorted(reports),
          "ptxas": ptxas})

    t = time.perf_counter()
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        rows = [rms_case(dtype, dev)]
        rows += [flash_case(dtype, dev, S) for S in (16, 1024)]
        rows += [paged_case(dtype, dev, T) for T in (1, 16)]
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
    same = [bucketed[r].token_ids == chunked[r].token_ids for r in bucketed]
    tok = [a == b for r in bucketed for a, b in
           zip(bucketed[r].token_ids, chunked[r].token_ids)]
    emit({"phase": "engine_chunked", "seconds": time.perf_counter() - t,
          "prefill_chunk": 16, **rec4,
          "greedy_agreement": {"identical_streams": sum(same),
                               "first_tokens_identical": sum(
                                   bucketed[r].token_ids[0] ==
                                   chunked[r].token_ids[0] for r in bucketed),
                               "of": len(same),
                               "token_rate": sum(tok) / len(tok)}})

    t = time.perf_counter()
    checks = []
    for rid in (0, 1):
        with torch.no_grad():
            logits = gpt.forward(params, prompts[rid][None], cfg)[0, -1]
        top2 = torch.topk(logits.float(), 2)
        margin = float(top2.values[0] - top2.values[1])
        pick = int(top2.indices[0])
        for mode, outs in (("bucketed", bucketed), ("chunked", chunked)):
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

    def main_shape(kernel, **match):
        return next(r for r in results
                    if r["kernel"] == kernel and r["dtype"] == "bfloat16"
                    and all(r.get(k) == v for k, v in match.items()))

    # (result row at the main path's bf16 shape, counter, route, source,
    #  replaced TPU kernel); launches sum phases 3 and 4
    table = (
        (main_shape("paged_prefill_attention", T=1),
         "paged_prefill_attention_kernel", "cuda",
         "paddle_tpu_torch/csrc/paged_attention.cu",
         "paddle_tpu/incubate/kernels/paged_attention.py:411"),
        (main_shape("flash_attention_fwd", S=1024), "flash_attention_fwd",
         "cuda", "paddle_tpu_torch/csrc/flash_attention.cu",
         "paddle_tpu/incubate/kernels/flash_attention.py:78"),
        (main_shape("rms_norm"), "rms_norm_fused", "triton",
         "paddle_tpu_torch/incubate/kernels/_rms_norm_triton.py",
         "paddle_tpu/incubate/kernels/rms_norm.py:15"),
    )
    kernels = [{
        "name": r["kernel"], "route": route, "source": source,
        "replaces": replaces,
        "launches": rec3["launches"][counter] + rec4["launches"][counter],
        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        for r, counter, route, source, replaces in table]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
