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

    python3 -m paddle_tpu_torch.inference.step_profile --spec-len 4

The fused step with speculative decoding (`LLMEngine(spec_len=K)`: the
fused program K + 1 rows wide, drafted slots at valid 1 + draft) on
`chip_smoke.py`'s `engine_spec` traffic (each request a seeded
SPEC_PATTERN-token pattern tiled to its PROMPT_LENS length), one engine
after the other in one process: "spec", drafts from a `ReplayProposer`
over the streams a spec-off engine generated first, filled where a slot
left its stream, and no back-off, so that every slot carries a K-token
draft every step (the step a draft model makes); "spec_ngram", the
n-gram proposer (with random weights it finds nothing to draft, so this
is the K + 1-wide step's cost without drafts); "spec_off".  Each prints
the fields above, with the tokens the window emitted a step and the
engine's spec counters over the window.

    python3 -m paddle_tpu_torch.inference.step_profile --window

The bucketed serving window of `chip_smoke.py`'s `engine_bucketed` phase,
twice on one engine (8 slots, page 16, buckets 512/1024/2048, the decode
program warmed first): 8 requests of 64-1024 prompt tokens x 32 new
tokens, the first pass building each bucket's prefill program at its first
use, the second (other prompts of the same lengths) finding them built.
Prints, per pass, the wall time, tokens/s, the mean and median step and
the mean of the steps that ran a one-shot prefill.  It takes only
`LLMEngine`'s public surface, so it also measures older trees of the
package (run it with that tree's root as the working directory).  Its
traffic and geometry (`PROMPT_LENS`, the buckets, the engine's slots and
page) are a copy of `chip_smoke.py`'s `PROMPT_LENS`, `SERVE_BUCKETS` and
`serve()`, kept here so that the older trees need nothing of this one:
change them together.

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

from .spec import DraftProposer


class ReplayProposer(DraftProposer):
    """Drafts each request's known greedy continuation: `streams` is
    [(prompt, generated tokens)] from a spec-off engine.  While a request's
    history is its prompt followed by a prefix of its stream, the draft is
    the stream's next tokens.  Off the stream (a near-tie the spec program
    rounded the other way) it drafts nothing, or with `fill` max_tokens
    copies of the last token (a draft that is there and wrong), so that
    every greedy slot carries a full draft every step.  A measurement
    stand-in for a draft model: with random weights no token of a greedy
    stream recurs, so the n-gram proposer never drafts."""

    max_lookback = 0            # the whole history: its prompt names it

    def __init__(self, streams, fill=False):
        self.streams = [(np.asarray(p, np.int32), np.asarray(g, np.int32))
                        for p, g in streams]
        self.fill = fill
        self.reset_stats()

    def propose(self, context, max_tokens):
        self.calls += 1
        ctx = np.asarray(context).reshape(-1)
        for prompt, gen in self.streams:
            n = ctx.size - prompt.size
            if 0 <= n <= gen.size and \
                    np.array_equal(ctx[:prompt.size], prompt) and \
                    np.array_equal(ctx[prompt.size:], gen[:n]):
                draft = gen[n:n + max_tokens]
                if not draft.size:
                    break
                self.hits += 1
                self.tokens_proposed += draft.size
                return draft.copy()
        if not self.fill:
            return None
        self.tokens_proposed += max_tokens
        return np.full((max_tokens,), ctx[-1], np.int32)

    def stats(self):
        return {"propose_calls": self.calls, "propose_hits": self.hits,
                "tokens_proposed": self.tokens_proposed,
                "hit_rate": self.hits / self.calls if self.calls else 0.0}

    def reset_stats(self):
        self.calls = self.hits = self.tokens_proposed = 0


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


# the same traffic as chip_smoke.py's PROMPT_LENS / SERVE_BUCKETS (and its
# SPEC_PATTERN and spec_traffic's seed): change them together
PROMPT_LENS = (64, 96, 160, 256, 384, 512, 768, 1024)
WINDOW_NEW = 32
SPEC_PATTERN = 16
SPEC_COUNTERS = ("decode_tokens", "verify_steps", "spec_events",
                 "spec_drafted_tokens", "spec_accepted_tokens",
                 "spec_emitted_tokens")


def window_profile(dev, smi):
    """Two passes of the bucketed serving window on one engine, after the
    kernels are built (`_cuda.build_all`, as `chip_smoke.py` does)."""
    import torch

    from ..incubate.kernels import _cuda
    from ..models import gpt
    from .engine import LLMEngine
    _cuda.build_all()
    cfg = gpt.llama3_8b()
    cfg.dtype = torch.bfloat16
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    eng = LLMEngine(params, cfg, num_slots=8, page_size=16,
                    max_model_len=2048, prefill_buckets=[512, 1024, 2048],
                    device=dev)
    eng.warm_decode()
    passes = []
    for seed in (0, 1):
        rng = np.random.RandomState(seed)
        for n in PROMPT_LENS:
            eng.add_request(rng.randint(0, cfg.vocab_size, n),
                            max_new_tokens=WINDOW_NEW)
        torch.cuda.synchronize()
        before = eng.stats()
        steps, prefill_steps = [], []
        t0 = time.perf_counter()
        while eng.has_work:
            n = eng.stats()["prefill_dispatches"]
            s = time.perf_counter()
            eng.step()
            dt = time.perf_counter() - s
            steps.append(dt)
            if eng.stats()["prefill_dispatches"] > n:
                prefill_steps.append(dt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = eng.stats()
        gen = len(PROMPT_LENS) * WINDOW_NEW
        passes.append({
            "seed": seed, "wall_s": wall, "tokens_per_s": gen / wall,
            "engine_steps": len(steps),
            "mean_step_ms": 1e3 * wall / len(steps),
            "median_step_ms": 1e3 * float(np.median(steps)),
            "prefill_steps": len(prefill_steps),
            "mean_prefill_step_ms": 1e3 * float(np.mean(prefill_steps)),
            "prefill_dispatches": st["prefill_dispatches"] -
                                  before["prefill_dispatches"],
            "prefill_executables": st["prefill_executables"],
            "graph_replays": st["graph_replays"] - before["graph_replays"]})
    return {"nvidia_smi": smi, "model": "llama3_8b", "dtype": "bf16",
            "window": "engine_bucketed", "passes": passes}


def main():
    import argparse

    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--window", action="store_true")
    ap.add_argument("--no-fuse", action="store_true")
    ap.add_argument("--weight-dtype", default=None)
    ap.add_argument("--kv-dtype", default=None)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--spec-len", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("step_profile: no CUDA device", file=sys.stderr)
        return 2
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
    if args.window:
        print(json.dumps(window_profile(dev, smi)))
        return 0
    cfg = gpt.llama3_8b()
    cfg.dtype = torch.bfloat16
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    if not args.spec_len:
        rng = np.random.RandomState(0)
        prompts = [rng.randint(0, cfg.vocab_size, n) for n in PROMPT_LENS]
        print(json.dumps(serve_profile(dev, smi, params, cfg, args, prompts,
                                       0)))
        return 0
    # chip_smoke.py's spec_traffic
    rng = np.random.RandomState(3)
    prompts = [np.resize(rng.randint(0, cfg.vocab_size, SPEC_PATTERN), n)
               for n in PROMPT_LENS]
    off = LLMEngine(params, cfg, num_slots=8, page_size=args.page_size,
                    max_model_len=2048, fuse=not args.no_fuse, device=dev,
                    weight_dtype=args.weight_dtype, kv_dtype=args.kv_dtype)
    for p in prompts:
        off.add_request(p, max_new_tokens=_window_new(args.spec_len))
    streams = off.run()
    del off
    replay = ReplayProposer([(p, streams[r].token_ids)
                             for r, p in enumerate(prompts)], fill=True)
    out = {"nvidia_smi": smi}
    for key, spec_len, proposer in (("spec", args.spec_len, replay),
                                    ("spec_ngram", args.spec_len, None),
                                    ("spec_off", 0, None)):
        out[key] = serve_profile(dev, smi, params, cfg, args, prompts,
                                 spec_len, proposer)
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


def _window_new(spec_len):
    """New tokens a request: a spec step emits up to spec_len + 1 tokens a
    slot, so enough that every slot still decodes through both windows."""
    return (2 * STEPS + 8) * (spec_len + 1)


def serve_profile(dev, smi, params, cfg, args, prompts, spec_len,
                  proposer=None):
    """One serving engine's steady decode steps, untraced and traced (see
    the module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .engine import LLMEngine
    fuse = not args.no_fuse
    # a given proposer drafts every step: no back-off from its rejected
    # drafts
    eng = LLMEngine(params, cfg, num_slots=8, page_size=args.page_size,
                    max_model_len=2048, fuse=fuse, spec_len=spec_len,
                    draft_proposer=proposer,
                    spec_backoff_window=0 if proposer else 8, device=dev,
                    weight_dtype=args.weight_dtype, kv_dtype=args.kv_dtype)
    dequant, dequant_ms = _dequant_profile(eng) \
        if eng.weight_dtype else (frozenset(), None)
    for p in prompts:
        eng.add_request(p, max_new_tokens=_window_new(spec_len))
    for _ in range(4):                  # admission + warm decode steps
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()            # the untraced window
    for _ in range(STEPS):
        eng.step()
    torch.cuda.synchronize()
    bare = (time.perf_counter() - t0) / STEPS
    before = eng.stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    after = eng.stats()
    kernels = _kernels(prof)
    busy = _busy_us(kernels)
    short, long_ = _gaps_us(kernels)
    groups, counts = {}, {}
    for e in kernels:
        g = _group(e.name, dequant)
        groups[g] = groups.get(g, 0.0) + e.time_range.end - e.time_range.start
        counts[g] = counts.get(g, 0) + 1
    per = 1e-3 / STEPS            # us over the window -> ms per step
    window = {k: after[k] - before[k] for k in SPEC_COUNTERS}
    proposer_stats = eng.proposer.stats() if spec_len else None
    del eng
    return {
        "nvidia_smi": smi, "model": "llama3_8b", "layers": cfg.num_layers,
        "dtype": "bf16", "slots": 8, "steps": STEPS, "fuse": fuse,
        "page_size": args.page_size, "weight_dtype": after["weight_dtype"],
        "kv_dtype": after["kv_dtype"], "running": after["running"],
        "spec_len": spec_len,
        "host_wall_ms_per_step": wall * 1e3 / STEPS,
        "device_busy_ms_per_step": busy * per,
        "device_idle_share": 1.0 - busy * 1e-6 / wall,
        "host_wall_ms_per_step_untraced": bare * 1e3,
        "device_idle_share_untraced": 1.0 - busy * 1e-6 / STEPS / bare,
        f"device_gap_ms_per_step_under_{GAP_US:g}us": short * per,
        f"device_gap_ms_per_step_over_{GAP_US:g}us": long_ * per,
        "kernel_launches_per_step": len(kernels) / STEPS,
        "graph_replays_per_step":
            (after["graph_replays"] - before["graph_replays"]) / STEPS,
        "tokens_per_step": window["decode_tokens"] / STEPS,
        "spec_window": window, "proposer": proposer_stats,
        "device_ms_per_step_by_group": {k: v * per for k, v in
                                        sorted(groups.items())},
        "launches_per_step_by_group": {k: v / STEPS for k, v in
                                       sorted(counts.items())},
        "dequant_device_ms_per_step": dequant_ms,
        "top_kernels": _by_name(kernels, STEPS)}


if __name__ == "__main__":
    sys.exit(main())
