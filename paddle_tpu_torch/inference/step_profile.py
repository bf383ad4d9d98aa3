"""Where a steady-state serving step of the PyTorch port spends its time.

    python3 -m paddle_tpu_torch.inference.step_profile

Builds Llama-3-8B (bf16, random weights from a seeded generator) in
`paddle_tpu_torch`'s `LLMEngine` on one CUDA card with the same geometry as
`chip_smoke.py` (8 slots, page 16, bucketed prefill), admits 8 requests of
64-1024 prompt tokens, lets every slot reach decode, times 8 fused decode
steps without the profiler, then traces 8 more with `torch.profiler`.
Each step is one CUDA-graph replay (the engine's default); the profiler
reports the graph's kernels by name, as it does eager launches.  Prints
one JSON line: the card, the host wall time per step of both windows, the
device-busy time per step (union of kernel intervals) and idle share of
the traced window (and the idle share of the untraced window against the
same busy time), the idle time between kernels split at GAP_US (short
gaps lie between kernels the card runs back to back, long ones wait on
the host), the kernels and graph replays per step, the device time per
step by kernel group (paged attention, RMSNorm, GEMM, other) and the top
kernels by device time with their launch counts.  Needs a card; exits
non-zero without one.

    python3 -m paddle_tpu_torch.inference.step_profile --no-fuse

The same with `LLMEngine(fuse=False)`: each traced step is one unfused
`decode_step_paged` dispatch, through the paged decode kernel (group
`paged_decode`), beside the fused step's numbers.

    python3 -m paddle_tpu_torch.inference.step_profile \
        --weight-dtype int8 --kv-dtype int8 --page-size 32

The int8 serving step (`LLMEngine(weight_dtype=, kv_dtype=)`, any page
size with `--page-size`): the paged kernels' int8 instantiations fall in
`paged_attention_int8` / `paged_decode_int8`, and the weight dequant in
`dequant`: every kernel whose name the step's dequant expressions launch
(`models.gpt._w` of each quantized block weight and the head's upcast,
profiled alone once before the window; small elementwise kernels of the
step with the same names land there too).  `dequant_device_ms_per_step`
times those expressions alone, one step's worth, on CUDA events.

    python3 -m paddle_tpu_torch.inference.step_profile --train

Profiles one train step of GPT-3 1.3B instead (bf16 params and moments,
remat, B=4, S=2048, one warm-up step first, as `chip_smoke.py`'s train
phase): the device time of the step by group (attention forward, attention
backward, GEMM, optimizer, other) beside the host wall and idle share.  The
optimizer is every kernel launched after the gradients are ready (the
script synchronizes between the two halves of the step).
"""
import json
import subprocess
import sys
import time

import numpy as np


def _group(name, dequant=frozenset()):
    n = name.lower()
    int8 = "_int8" if "signed char" in n else ""
    if "paged_prefill_kernel" in n:
        return "paged_attention" + int8
    if "paged_decode_kernel" in n:
        return "paged_decode" + int8
    if name in dequant:
        return "dequant"
    if "flash_fwd_" in n:               # flash_fwd_kernel, flash_fwd_wgmma
        return "attention_fwd"
    if "flash_bwd_" in n:
        return "attention_bwd"
    if "rms_kernel" in n or "rms_tma_kernel" in n:
        return "rms_norm"
    if any(s in n for s in ("gemm", "gemv", "nvjet", "cutlass", "sm90_",
                            "ampere_", "cublas")):
        return "gemm"
    return "other"


STEPS = 8
GAP_US = 20.0           # idle gaps shorter than this: between queued kernels
OPT_MARK = "step_profile.optimizer"     # record_function range of the update


def _kernels(prof):
    """Device events, without the profiler's GPU copy of OPT_MARK."""
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and
            e.name != OPT_MARK]


def _busy_us(kernels):
    """Union of the kernels' device intervals, in us."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _gaps_us(kernels):
    """Idle time between the kernels' merged device intervals, in us:
    (gaps under GAP_US, gaps of GAP_US or more)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    short = long_ = 0.0
    end = None
    for s, e in spans:
        if end is not None and s > end:
            if s - end < GAP_US:
                short += s - end
            else:
                long_ += s - end
        end = e if end is None else max(end, e)
    return short, long_


def _by_name(kernels, steps):
    by_name = {}
    for e in kernels:
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.end - e.time_range.start, c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    return [{"name": n[:90], "ms_per_step": t * 1e-3 / steps,
             "launches_per_step": c / steps} for n, (t, c) in top]


def train_profile(dev, smi):
    """One GPT-3 1.3B train step under the profiler (see the module
    docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from ..models import gpt
    from ..parallel import HybridParallelTrainer, MeshConfig
    cfg = gpt.gpt3_1p3b()
    cfg.dtype = torch.bfloat16
    trainer = HybridParallelTrainer(cfg, MeshConfig(remat=True),
                                    moment_dtype=torch.bfloat16, device=dev)
    rng = np.random.RandomState(0)
    tok = rng.randint(0, cfg.vocab_size, (4, 2048)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1)
    trainer.train_step(tok, lab)                        # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, grads = trainer.loss_and_grads(tok, lab)
        torch.cuda.synchronize()
        with record_function(OPT_MARK):
            trainer.apply_gradients(grads)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    opt_start = next(e.time_range.start for e in prof.events()
                     if e.name == OPT_MARK and
                     e.device_type == torch.autograd.DeviceType.CPU)
    kernels = _kernels(prof)
    groups = {}
    for e in kernels:
        g = "optimizer" if e.time_range.start >= opt_start else \
            _group(e.name)
        groups[g] = groups.get(g, 0.0) + e.time_range.end - e.time_range.start
    busy = _busy_us(kernels)
    return {
        "nvidia_smi": smi, "model": "gpt3_1p3b", "layers": cfg.num_layers,
        "dtype": "bf16", "batch": [4, 2048], "remat": True, "steps": 1,
        "host_wall_ms_per_step": wall * 1e3,
        "device_busy_ms_per_step": busy * 1e-3,
        "device_idle_share": 1.0 - busy * 1e-6 / wall,
        "kernel_launches_per_step": len(kernels),
        "device_ms_per_step_by_group": {k: v * 1e-3 for k, v in
                                        sorted(groups.items())},
        "top_kernels": _by_name(kernels, 1)}


def _dequant_work(eng):
    """One step's weight dequant of an int8 engine, as its step programs
    run it: `_w` of every quantized block weight, the head's upcast."""
    from ..models import gpt
    params, cfg = eng.params, eng.config
    names = [k[:-2] for k in params["blocks"] if k.endswith("_q")]
    for l in range(cfg.num_layers):
        bp = gpt._layer(params["blocks"], l)
        for n in names:
            gpt._w(bp, n, cfg.dtype)
    head = params.get("lm_head_q", params.get("wte_q"))
    head.to(cfg.dtype)


def _dequant_profile(eng):
    """(names of the kernels the dequant launches, its device ms a step on
    CUDA events)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    _dequant_work(eng)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _dequant_work(eng)
        torch.cuda.synchronize()
    names = frozenset(e.name for e in _kernels(prof))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        _dequant_work(eng)
    end.record()
    torch.cuda.synchronize()
    return names, start.elapsed_time(end) / 3


def main():
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--no-fuse", action="store_true")
    ap.add_argument("--weight-dtype", default=None)
    ap.add_argument("--kv-dtype", default=None)
    ap.add_argument("--page-size", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("step_profile: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from ..models import gpt
    from .engine import LLMEngine

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    if args.train:
        print(json.dumps(train_profile(dev, smi)))
        return 0
    fuse = not args.no_fuse
    cfg = gpt.llama3_8b()
    cfg.dtype = torch.bfloat16
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    eng = LLMEngine(params, cfg, num_slots=8, page_size=args.page_size,
                    max_model_len=2048, fuse=fuse, device=dev,
                    weight_dtype=args.weight_dtype, kv_dtype=args.kv_dtype)
    del params                          # an int8 engine keeps its own copy
    dequant, dequant_ms = _dequant_profile(eng) \
        if eng.weight_dtype else (frozenset(), None)
    rng = np.random.RandomState(0)
    for n in (64, 96, 160, 256, 384, 512, 768, 1024):
        eng.add_request(rng.randint(0, cfg.vocab_size, n),
                        max_new_tokens=2 * STEPS + 8)
    for _ in range(4):                  # admission + warm decode steps
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()            # the untraced window
    for _ in range(STEPS):
        eng.step()
    torch.cuda.synchronize()
    bare = (time.perf_counter() - t0) / STEPS
    replays = eng.stats()["graph_replays"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = _kernels(prof)
    busy = _busy_us(kernels)
    short, long_ = _gaps_us(kernels)
    groups, counts = {}, {}
    for e in kernels:
        g = _group(e.name, dequant)
        groups[g] = groups.get(g, 0.0) + e.time_range.end - e.time_range.start
        counts[g] = counts.get(g, 0) + 1
    per = 1e-3 / STEPS            # us over the window -> ms per step
    print(json.dumps({
        "nvidia_smi": smi, "model": "llama3_8b", "layers": cfg.num_layers,
        "dtype": "bf16", "slots": 8, "steps": STEPS, "fuse": fuse,
        "page_size": args.page_size, "weight_dtype": eng.weight_dtype,
        "kv_dtype": eng.kv_dtype, "running": eng.stats()["running"],
        "host_wall_ms_per_step": wall * 1e3 / STEPS,
        "device_busy_ms_per_step": busy * per,
        "device_idle_share": 1.0 - busy * 1e-6 / wall,
        "host_wall_ms_per_step_untraced": bare * 1e3,
        "device_idle_share_untraced": 1.0 - busy * 1e-6 / STEPS / bare,
        f"device_gap_ms_per_step_under_{GAP_US:g}us": short * per,
        f"device_gap_ms_per_step_over_{GAP_US:g}us": long_ * per,
        "kernel_launches_per_step": len(kernels) / STEPS,
        "graph_replays_per_step":
            (eng.stats()["graph_replays"] - replays) / STEPS,
        "device_ms_per_step_by_group": {k: v * per for k, v in
                                        sorted(groups.items())},
        "launches_per_step_by_group": {k: v / STEPS for k, v in
                                       sorted(counts.items())},
        "dequant_device_ms_per_step": dequant_ms,
        "top_kernels": _by_name(kernels, STEPS)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
