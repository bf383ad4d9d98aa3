"""Where a steady-state serving step of the PyTorch port spends its time.

    python3 -m paddle_tpu_torch.inference.step_profile

Builds Llama-3-8B (bf16, random weights from a seeded generator) in
`paddle_tpu_torch`'s `LLMEngine` on one CUDA card with the same geometry as
`chip_smoke.py` (8 slots, page 16, bucketed prefill), admits 8 requests of
64-1024 prompt tokens, lets every slot reach decode, then traces 8
fused decode steps with `torch.profiler`.  Prints one JSON line: the card,
the window's host wall time per step, the device-busy time per step (union
of kernel intervals) and idle share, the device time per step by kernel
group (paged attention, RMSNorm, GEMM, other) and the top kernels by device
time with their launch counts.  Needs a card; exits non-zero without one.
"""
import json
import subprocess
import sys
import time

import numpy as np


def _group(name):
    n = name.lower()
    if "paged_prefill_kernel" in n:
        return "paged_attention"
    if "rms_kernel" in n:
        return "rms_norm"
    if any(s in n for s in ("gemm", "gemv", "nvjet", "cutlass", "sm90_",
                            "ampere_", "cublas")):
        return "gemm"
    return "other"


STEPS = 8


def main():
    import torch
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
    cfg = gpt.llama3_8b()
    cfg.dtype = torch.bfloat16
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    eng = LLMEngine(params, cfg, num_slots=8, page_size=16,
                    max_model_len=2048, device=dev)
    rng = np.random.RandomState(0)
    for n in (64, 96, 160, 256, 384, 512, 768, 1024):
        eng.add_request(rng.randint(0, cfg.vocab_size, n),
                        max_new_tokens=STEPS + 8)
    for _ in range(4):                  # admission + warm decode steps
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:                  # union of kernel intervals, in us
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name, groups = {}, {}
    for e in kernels:
        d = e.time_range.end - e.time_range.start
        t, c = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + d, c + 1)
        groups[_group(e.name)] = groups.get(_group(e.name), 0.0) + d
    per = 1e-3 / STEPS            # us over the window -> ms per step
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    print(json.dumps({
        "nvidia_smi": smi, "model": "llama3_8b", "layers": cfg.num_layers,
        "dtype": "bf16", "slots": 8, "steps": STEPS,
        "running": eng.stats()["running"],
        "host_wall_ms_per_step": wall * 1e3 / STEPS,
        "device_busy_ms_per_step": busy * per,
        "device_idle_share": 1.0 - busy * 1e-6 / wall,
        "kernel_launches_per_step": len(kernels) / STEPS,
        "device_ms_per_step_by_group": {k: v * per for k, v in
                                        sorted(groups.items())},
        "top_kernels": [{"name": n[:90], "ms_per_step": t * per,
                         "launches_per_step": c / STEPS}
                        for n, (t, c) in top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
