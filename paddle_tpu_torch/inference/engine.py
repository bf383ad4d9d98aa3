"""Continuous-batching serving engine — port of
`paddle_tpu/inference/engine.py::LLMEngine`, fused and unfused.

Paged KV pool (`models.gpt.init_paged_cache`) + per-slot page tables
(`inference.cache.PagedKVCache`), reservation admission, and ONE fused
program per steady-state step (`models.gpt.serve_step_paged`): decode slots
ride at valid=1, and in chunked mode (`prefill_chunk=N`) the oldest prompt's
next chunk rides the same batch at valid=chunk tokens.  Bucketed mode
(`prefill_chunk=None`, the default) prefills a whole prompt at admission
with one `prefill_paged` pass padded to a power-of-2 bucket.  Argmax,
temperature/top-k sampling and the per-request greedy mask run on the
device; the Gumbel noise is drawn from the engine's `torch.Generator` before
each step into the step's noise input.  The host fetches only the [B, T]
int32 token buffer.  With `double_buffer=True` (default) that fetch happens
at the top of the NEXT step, so the device computes while the host
schedules.

Each step program (the fused step; the unfused decode and chunk programs)
is a `graphs.StepProgram`: its inputs are staged into static buffers and,
on the card, the step is ONE `CUDAGraph.replay()` (the reference's one
jitted executable a step).  `warm_decode()` builds the decode-side program
on inert inputs; an engine that is not warmed builds each program at its
first dispatch.  `stats()` counts the programs under the reference's keys
(`decode_executables`, ..., held within
`analysis.registry.SERVE_PROGRAM_BUDGET`) beside `graph_replays`.  The
bucketed one-shot prefill stays eager (one program per bucket shape).

`fuse=False` is the reference's three-program step, the A/B baseline of the
fused one: each iteration advances the oldest mid-prefill prompt by one
chunk through `prefill_chunk_paged` (chunked mode), then runs one
`decode_step_paged` over every decoding slot (mid-prefill slots get null
table rows, so their KV writes land on the null page); both fetch their
token before the step returns (no double buffering).

Quantized serving, as the reference's: `weight_dtype="int8"` quantizes the
serving matmul weights once at init (`quantization.quantize_serving_params`,
dequantized one layer at a time inside the step programs), `kv_dtype="int8"`
makes the pool int8 with per-token scale lanes, which the paged kernels'
int8 lanes dequantize on read.  Neither adds a program.

Knobs of later slices (prefix cache, speculative decoding, optimistic
admission and preemption, KV tiering, roles, fault injection, tensor
parallelism, request tracing, injectable clocks) are accepted only at the
reference's defaults or off values and raise `NotImplementedError`
otherwise.  `prefix_cache`, `kv_tier` and `request_tracing` default to False
here (True in the reference).
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import gpt as gpt_mod
from ..quantization.serving import (normalize_quant_dtype,
                                    quantize_serving_params)
from .cache import PagedKVCache
from .graphs import StepProgram


@dataclasses.dataclass(eq=False)
class Request:
    """One generation request.  temperature=None inherits the engine's
    sampling mode; 0.0 forces the greedy pick for this request.  eq=False:
    numpy prompts have no scalar truth value."""
    prompt: np.ndarray
    max_new_tokens: int = 16
    request_id: int = -1
    t_enqueue: float = 0.0
    temperature: Optional[float] = None
    priority: int = 0


@dataclasses.dataclass
class RequestOutput:
    request_id: int
    prompt: np.ndarray
    token_ids: List[int]            # generated tokens (prompt excluded)
    finish_reason: str              # "stop" | "length" | "rejected"
    cached_tokens: int = 0          # prefix-cache hits: 0 in this slice
    ttft_s: Optional[float] = None

    @property
    def tokens(self) -> np.ndarray:
        """prompt + generated."""
        return np.concatenate([np.asarray(self.prompt, np.int64),
                               np.asarray(self.token_ids, np.int64)])


@dataclasses.dataclass
class _Running:
    request: Request
    slot: int
    generated: List[int]
    ttft_s: Optional[float] = None
    greedy: bool = True


@dataclasses.dataclass
class _Prefilling:
    """A slot whose prompt KV is still landing: `filled` prompt tokens
    are in pages."""
    request: Request
    slot: int
    filled: int = 0


def _pow2_buckets(lo: int, hi: int) -> List[int]:
    out = []
    b = lo
    while b <= hi:
        out.append(b)
        b *= 2
    return out


def _later(what: str, item: str):
    return NotImplementedError(
        f"{what} arrives with a later slice of the port (ROADMAP Queue 1: "
        f"{item})")


class LLMEngine:
    """Continuous-batching engine over the functional GPT core, on
    `device` (None: the CUDA card, raising without one).  `params` must
    already lie on that device (`models.gpt.init_params` or
    `models.convert.params_from_numpy`).  `_eager=True` runs the step
    programs without CUDA graphs on the card (a comparison switch for the
    card tests and `chip_smoke.py`; the reference has no such engine)."""

    def __init__(self, params, config: gpt_mod.GPTConfig, *,
                 num_slots: int = 4, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 max_model_len: Optional[int] = None,
                 prefill_buckets: Optional[List[int]] = None,
                 prefill_chunk=None,
                 prefix_cache: bool = False,
                 eos_token_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 spec_len: int = 0,
                 draft_proposer=None,
                 spec_backoff_window: int = 8,
                 fuse: bool = True,
                 double_buffer: Optional[bool] = None,
                 admission: str = "reservation",
                 preempt: str = "recompute",
                 swap_pool_pages: Optional[int] = None,
                 kv_tier: bool = False,
                 spill_dir: Optional[str] = None,
                 spill_disk_pages: Optional[int] = None,
                 page_store=None,
                 role: Optional[str] = None,
                 fault_plan=None,
                 weight_dtype: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 mesh=None, mp: Optional[int] = None,
                 seed: int = 0,
                 clock=None,
                 trace_ring: int = 512,
                 request_tracing: bool = False,
                 trace_retention: Optional[int] = 4096,
                 device=None, _eager: bool = False):
        self.weight_dtype = normalize_quant_dtype(weight_dtype,
                                                  "weight_dtype")
        self.kv_dtype = normalize_quant_dtype(kv_dtype, "kv_dtype")
        if prefix_cache:
            raise _later("prefix_cache=True", "prefix cache and COW copy")
        if spec_len or draft_proposer is not None or \
                spec_backoff_window != 8:
            raise _later(f"spec_len={spec_len} (fused or not), "
                         f"draft_proposer and spec_backoff_window",
                         "speculative decoding")
        if admission != "reservation" or preempt != "recompute" or \
                fault_plan is not None or swap_pool_pages is not None:
            raise _later("optimistic admission, preempt='swap', fault_plan "
                         "and swap_pool_pages",
                         "optimistic admission and preemption")
        if mesh is not None or (mp is not None and mp > 1):
            raise _later("mesh/mp>1", "tensor-parallel serving")
        if kv_tier or spill_dir is not None or page_store is not None or \
                role is not None or spill_disk_pages is not None:
            raise _later("kv_tier, spill_dir, spill_disk_pages, page_store "
                         "and role", "KV tiering, durable store and roles")
        if request_tracing or clock is not None or trace_ring != 512 or \
                trace_retention != 4096:
            raise _later("request_tracing, clock, trace_ring and "
                         "trace_retention", "metrics, tracing and health")

        self.device = gpt_mod.resolve_device(device)
        table = params["wte_q" if "wte_q" in params else "wte"]
        if table.device != self.device:
            raise ValueError(f"params live on {table.device}, the engine on "
                             f"{self.device}")
        if self.weight_dtype == "int8":
            # once, on the device (dequant rides inside the step programs)
            params = quantize_serving_params(params, config)
        self.params = params
        self.config = config
        self.eos_token_id = eos_token_id
        max_model_len = max_model_len or config.max_seq_len
        if max_model_len % page_size:
            raise ValueError("max_model_len must be a multiple of page_size")
        if not config.use_rope and max_model_len > config.max_seq_len:
            raise ValueError(
                f"max_model_len {max_model_len} exceeds max_seq_len "
                f"{config.max_seq_len} (learned positions)")
        self.max_model_len = max_model_len
        max_pages_per_slot = max_model_len // page_size
        if num_pages is None:
            # default: half the dense footprint (+ the null page)
            num_pages = max(2, num_slots * max_pages_per_slot // 2 + 1)
        if prefill_buckets is None:
            prefill_buckets = _pow2_buckets(page_size, max_model_len)
            if not prefill_buckets or prefill_buckets[-1] != max_model_len:
                prefill_buckets.append(max_model_len)
        self.buckets = sorted(prefill_buckets)
        for b in self.buckets:
            if b % page_size or b > max_model_len:
                raise ValueError(f"bucket {b} incompatible with page_size "
                                 f"{page_size} / max_model_len {max_model_len}")
        if prefill_chunk == "auto":
            # spec off: one page per chunk (the reference's rule)
            prefill_chunk = min(page_size, max_model_len)
        if prefill_chunk is not None and \
                not 1 <= prefill_chunk <= max_model_len:
            raise ValueError(f"prefill_chunk {prefill_chunk} outside "
                             f"[1, {max_model_len}]")
        self.prefill_chunk = prefill_chunk
        self.chunked = prefill_chunk is not None
        self.fused = bool(fuse)
        # the unfused programs fetch their tokens at once (reference rule)
        self.double_buffer = self.fused and \
            (True if double_buffer is None else bool(double_buffer))
        # the fused program's token width: the chunk lane in chunked mode,
        # a single decode token otherwise
        self._fused_T = prefill_chunk if self.chunked else 1
        self.cache = PagedKVCache(num_pages, page_size, num_slots,
                                  max_pages_per_slot)
        self._pool = gpt_mod.init_paged_cache(config, num_pages, page_size,
                                              device=self.device,
                                              kv_dtype=self.kv_dtype)
        self._queue: deque = deque()
        self._running: Dict[int, _Running] = {}
        self._prefilling: Dict[int, _Prefilling] = {}   # slot -> state, FIFO
        self._free_slots = list(range(num_slots - 1, -1, -1))
        self._ids = itertools.count()
        self._outputs: Dict[int, RequestOutput] = {}
        self._sample = bool(temperature and temperature > 0.0)
        self._temperature = temperature
        self._sampling = (self._sample, temperature, top_k)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._capture = not _eager
        self._programs: Dict[str, StepProgram] = {}
        self._seen_buckets: set = set()
        # the un-synced result of the last fused dispatch (double_buffer)
        self._inflight: Optional[Dict[str, object]] = None
        self._now = time.perf_counter
        self._c = dict.fromkeys(
            ("engine_steps", "decode_iterations", "decode_tokens",
             "fused_dispatches", "decode_dispatches", "chunk_dispatches",
             "prefill_dispatches", "prefill_chunks", "prefilled_tokens",
             "admitted_requests", "finished_requests", "rejected_requests"),
            0)

    # ---- request intake ---------------------------------------------------
    def add_request(self, prompt, max_new_tokens: int = 16,
                    temperature: Optional[float] = None,
                    priority: int = 0,
                    deadline_s: Optional[float] = None) -> int:
        """Enqueue one request; same validation as the reference.  A request
        whose worst-case footprint (prompt + max_new_tokens) exceeds the
        whole pool is rejected at once (finish_reason="rejected")."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, "
                             f"got {max_new_tokens}")
        if temperature is not None and temperature < 0.0:
            raise ValueError(f"temperature must be >= 0.0, got {temperature}")
        if temperature is not None and temperature > 0.0:
            if not self._sample:
                raise ValueError(
                    "engine built greedy (temperature=0.0) cannot serve "
                    "sampled requests; construct it with temperature > 0")
            if temperature != self._temperature:
                raise ValueError(
                    f"per-request temperature {temperature} != engine "
                    f"temperature {self._temperature}; only the greedy path "
                    f"(temperature=0.0) overrides per request")
        if not self.chunked and prompt.size > self.buckets[-1]:
            raise ValueError(f"prompt length {prompt.size} exceeds largest "
                             f"prefill bucket {self.buckets[-1]}")
        total = prompt.size + max_new_tokens
        if total > self.max_model_len:
            raise ValueError(f"prompt + max_new_tokens = {total} exceeds "
                             f"max_model_len {self.max_model_len}")
        if deadline_s is not None:
            raise _later("deadline_s", "optimistic admission and preemption")
        rid = next(self._ids)
        req = Request(prompt, max_new_tokens, rid, self._now(), temperature,
                      priority)
        if self.cache.pages_needed(total) > self.cache.num_pages - 1:
            self._c["rejected_requests"] += 1
            self._finish_output(req, [], "rejected", None)
            return rid
        self._queue.append(req)
        return rid

    def _req_greedy(self, req: Request) -> bool:
        t = req.temperature
        return (not self._sample) if t is None else t <= 0.0

    def _finish_output(self, req: Request, token_ids: List[int], reason: str,
                       ttft: Optional[float]) -> RequestOutput:
        out = RequestOutput(req.request_id, req.prompt, token_ids, reason,
                            ttft_s=ttft)
        self._outputs[out.request_id] = out
        return out

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"no bucket for prompt length {n}")

    def _h2d(self, a, dtype=None) -> torch.Tensor:
        """Per-step scheduler input -> device tensor (a private copy, so
        later host edits of the numpy source cannot reach it)."""
        return torch.from_numpy(np.array(a, dtype)).to(self.device)

    def _noise(self, rows: int) -> torch.Tensor:
        """Gumbel noise [rows, V] for one pick, from the engine's
        generator."""
        return gpt_mod.gumbel_noise((rows, self.config.vocab_size),
                                    self.config.dtype, self._generator,
                                    self.device)

    # ---- step programs ----------------------------------------------------
    def _program(self, role: str) -> StepProgram:
        """The step program of `role` ("fused", or the unfused "decode" and
        "chunk"), made at first use (built at its first staging)."""
        prog = self._programs.get(role)
        if prog is not None:
            return prog
        mgr, c = self.cache, self.config
        B, P = mgr.num_slots, mgr.max_pages_per_slot
        i32 = torch.int32
        if role == "fused":
            rows, T = B, self._fused_T
            inputs = {"tokens": ((B, T), i32, 0),
                      "table": ((B, P), i32, 0),
                      "q_offset": ((B,), i32, 0), "valid": ((B,), i32, 1)}
        elif role == "decode":
            rows = B
            inputs = {"tokens": ((B,), i32, 0), "table": ((B, P), i32, 0),
                      "lengths": ((B,), i32, 0)}
        else:
            rows = 1
            inputs = {"tokens": ((1, self.prefill_chunk), i32, 0),
                      "table": ((1, P), i32, 0),
                      "q_offset": ((1,), i32, 0), "valid": ((1,), i32, 1)}
        inputs["greedy"] = ((rows,), torch.bool, False)
        if self._sample:
            inputs["noise"] = ((rows, c.vocab_size), c.dtype, 0.0)
        # the body holds params, pool and config, never the engine, so the
        # graphs go with the engine
        body = functools.partial(_BODIES[role], self.params, c, self._pool,
                                 self._sampling)
        prog = StepProgram(role, body, inputs, self.device,
                           capture=self._capture, device_fed=("noise",))
        self._programs[role] = prog
        return prog

    def _dispatch(self, role: str, **values) -> StepProgram:
        """Stage one step's inputs (and its noise) and run it."""
        prog = self._program(role)
        if self._sample:
            values["noise"] = self._noise(prog.inputs["greedy"].shape[0])
        prog.stage(**values)
        prog.run()
        return prog

    def warm_decode(self) -> None:
        """Build the decode-side program (the fused step, or the unfused
        decode program) on inert inputs, every table row on the null page:
        on the card its warm-up run and its graph capture.  Reference name
        and contract; here the generator is not drawn from, so sampled
        streams do not change."""
        self._program("fused" if self.fused else "decode").build()

    # ---- scheduler --------------------------------------------------------
    def step(self) -> List[RequestOutput]:
        """One engine iteration: harvest the previous fused dispatch
        (double-buffered mode), admit queued requests into free slots, stage
        at most one prefill chunk (chunked mode), then dispatch ONE fused
        program over every decode slot and the chunk.  Unfused: one chunk
        program (chunked mode), then one decode program.  Returns the
        requests that finished this iteration."""
        finished: List[RequestOutput] = []
        self._harvest(finished)         # step n-1's tokens land first
        self._admit(finished)
        if self.fused:
            chunk_job = self._stage_chunk() if self.chunked else None
            if self._running or chunk_job is not None:
                self._fused_iter(chunk_job, finished)
        else:
            self._prefill_tick(finished)
            if self._running:
                self._decode_iter(finished)
        self._c["engine_steps"] += 1
        return finished

    def _admit(self, finished: List[RequestOutput]) -> None:
        """Reservation admission: a request enters a free slot once the pool
        holds its whole prompt + max_new_tokens footprint."""
        mgr = self.cache
        while self._queue and self._free_slots:
            req = self._queue[0]
            slot = self._free_slots[-1]
            lp = req.prompt.size
            try:
                row = mgr.allocate(slot, lp + req.max_new_tokens)
            except RuntimeError:        # out of KV pages
                if not self._running and not self._prefilling and \
                        mgr.pages_in_use() == 0:
                    raise ValueError(
                        f"request {req.request_id} needs "
                        f"{mgr.pages_needed(lp + req.max_new_tokens)} pages "
                        f"but the pool only has {mgr.num_pages - 1}")
                break                   # wait for pages to free up
            self._queue.popleft()
            self._free_slots.pop()
            self._c["admitted_requests"] += 1
            if self.chunked:
                self._prefilling[slot] = _Prefilling(req, slot)
                continue
            # one-shot bucketed prefill, synchronous at admission
            bucket = self._bucket_for(lp)
            ids = np.zeros((1, bucket), np.int32)
            ids[0, :lp] = req.prompt
            pages = row[:bucket // mgr.page_size][None, :]
            logits, self._pool = gpt_mod.prefill_paged(
                self.params, self._h2d(ids), self.config, self._pool,
                self._h2d(pages), self._h2d([lp], np.int32))
            first = pick_tokens(logits, self._h2d([self._req_greedy(req)]),
                                self._noise(1) if self._sample else None,
                                self._sampling)
            self._seen_buckets.add(bucket)
            self._c["prefill_dispatches"] += 1
            self._c["prefilled_tokens"] += lp
            first = int(first[0])       # blocks on the result
            self._start_decoding(req, slot, first, finished)

    def _prefill_tick(self, finished: List[RequestOutput]) -> None:
        """Unfused chunked mode: advance the oldest mid-prefill prompt by
        ONE chunk through the standalone chunk program; the chunk that
        completes the prompt picks its first token and joins the decode
        set."""
        if not self._prefilling:
            return
        slot, st = next(iter(self._prefilling.items()))
        req = st.request
        lp, C = req.prompt.size, self.prefill_chunk
        n = min(C, lp - st.filled)
        ids = np.zeros((1, C), np.int32)
        ids[0, :n] = req.prompt[st.filled:st.filled + n]
        # every chunk picks (and draws noise), as the reference's chunk
        # program does; only the last chunk's token is used
        prog = self._dispatch(
            "chunk", tokens=ids, table=self.cache.page_table[slot][None, :],
            q_offset=st.filled, valid=n, greedy=self._req_greedy(req))
        tok = prog.result()
        self._c["chunk_dispatches"] += 1
        self._c["prefill_chunks"] += 1
        self._c["prefilled_tokens"] += n
        st.filled += n
        if st.filled == lp:
            del self._prefilling[slot]
            self._start_decoding(req, slot, int(tok[0]), finished)

    def _decode_iter(self, finished: List[RequestOutput]) -> None:
        """Unfused decode iteration (speculative decoding off): every
        running slot rides one `decode_step_paged` dispatch."""
        self._c["decode_iterations"] += 1
        self._vanilla_decode_iter(list(self._running), finished)

    def _vanilla_decode_iter(self, slots: List[int],
                             finished: List[RequestOutput]) -> None:
        mgr = self.cache
        tokens = np.zeros((mgr.num_slots,), np.int32)
        greedy = np.zeros((mgr.num_slots,), bool)
        for slot in slots:
            seq = self._running[slot]
            tokens[slot] = seq.generated[-1]
            greedy[slot] = seq.greedy
        # mid-prefill slots and running slots outside `slots` must look
        # inactive: a null table row routes their (garbage) KV write to the
        # null page instead of a position inside the slot's real pages
        table = mgr.page_table.copy()
        for slot in range(mgr.num_slots):
            if slot in self._prefilling or \
                    (slot in self._running and slot not in slots):
                table[slot, :] = 0
        nxt = self._dispatch("decode", tokens=tokens, table=table,
                             lengths=mgr.lengths, greedy=greedy).result()
        self._c["decode_dispatches"] += 1
        self._c["decode_tokens"] += len(slots)
        for slot in slots:
            seq = self._running[slot]
            mgr.lengths[slot] += 1          # the token just fed is cached
            seq.generated.append(int(nxt[slot]))
            if self._maybe_finish(seq, finished):
                del self._running[slot]

    def _stage_chunk(self) -> Optional[Dict[str, object]]:
        """Chunked mode: describe the oldest mid-prefill slot's next chunk
        for the fused batch.  A chunk that completes its prompt leaves
        `_prefilling` now and joins the decode set at harvest, when its
        first token is known."""
        if not self._prefilling:
            return None
        slot, st = next(iter(self._prefilling.items()))
        lp = st.request.prompt.size
        n = min(self.prefill_chunk, lp - st.filled)
        job = {"slot": slot, "n": n, "q_offset": st.filled, "st": st,
               "done": st.filled + n == lp}
        st.filled += n
        self._c["prefill_chunks"] += 1
        self._c["prefilled_tokens"] += n
        if job["done"]:
            del self._prefilling[slot]
        return job

    def _fused_iter(self, chunk_job: Optional[Dict[str, object]],
                    finished: List[RequestOutput]) -> None:
        """Build and dispatch the fused program: running slots decode at
        valid=1, the staged chunk rides at valid=chunk tokens, every other
        slot gets a null table row (its KV goes to the null page)."""
        mgr = self.cache
        B, T = mgr.num_slots, self._fused_T
        if self._running:
            self._c["decode_iterations"] += 1
        tokens = np.zeros((B, T), np.int32)
        valid = np.ones((B,), np.int32)
        qoff = np.zeros((B,), np.int32)
        greedy = np.zeros((B,), bool)
        table = mgr.page_table.copy()
        slots: List[int] = []
        chunk_slot = chunk_job["slot"] if chunk_job is not None else None
        for slot in range(B):
            seq = self._running.get(slot)
            if seq is not None:
                slots.append(slot)
                tokens[slot, 0] = seq.generated[-1]
                qoff[slot] = mgr.lengths[slot]
                greedy[slot] = seq.greedy
            elif slot == chunk_slot:
                st, n, q0 = chunk_job["st"], chunk_job["n"], \
                    chunk_job["q_offset"]
                tokens[slot, :n] = st.request.prompt[q0:q0 + n]
                valid[slot] = n
                qoff[slot] = q0
                greedy[slot] = self._req_greedy(st.request)
            else:
                table[slot, :] = 0          # inactive: KV to the null page
        prog = self._dispatch("fused", tokens=tokens, table=table,
                              q_offset=qoff, valid=valid, greedy=greedy)
        self._c["fused_dispatches"] += 1
        inflight = {"prog": prog, "slots": slots, "chunk": chunk_job}
        if self.double_buffer:
            self._inflight = inflight
        else:
            self._harvest(finished, inflight)

    def _harvest(self, finished: List[RequestOutput],
                 inflight: Optional[Dict[str, object]] = None) -> None:
        """Fetch the [B, T] token buffer of a fused dispatch (the step's only
        device->host transfer, waited for on an event), emit each running
        slot's token, move a completed chunk's slot into the decode set,
        retire finishers."""
        inf = inflight if inflight is not None else self._inflight
        if inflight is None:
            self._inflight = None
        if inf is None:
            return
        out = inf["prog"].result()              # waits for the device result
        for slot in inf["slots"]:
            seq = self._running[slot]
            if self._emit_slot(seq, slot, [int(out[slot, 0])], finished):
                del self._running[slot]
        cj = inf["chunk"]
        if cj is not None and cj["done"]:
            self._start_decoding(cj["st"].request, cj["slot"],
                                 int(out[cj["slot"], cj["n"] - 1]), finished)

    def _emit_slot(self, seq: _Running, slot: int, emitted: List[int],
                   finished: List[RequestOutput]) -> bool:
        """Apply one slot's emission (budget truncation, EOS cut, length
        advance) and retire it if it finished.  Returns True when the
        caller must drop the slot from the running set."""
        room = seq.request.max_new_tokens - len(seq.generated)
        emitted = emitted[:room]
        if self.eos_token_id is not None and self.eos_token_id in emitted:
            emitted = emitted[:emitted.index(self.eos_token_id) + 1]
        self.cache.lengths[slot] += len(emitted)
        seq.generated.extend(emitted)
        self._c["decode_tokens"] += len(emitted)
        return self._maybe_finish(seq, finished)

    def _start_decoding(self, req: Request, slot: int, first: int,
                        finished: List[RequestOutput]) -> None:
        """Prompt fully in pages + first token picked: join the decode
        set."""
        self.cache.lengths[slot] = req.prompt.size
        seq = _Running(req, slot, [first], self._now() - req.t_enqueue,
                       self._req_greedy(req))
        if not self._maybe_finish(seq, finished):
            self._running[slot] = seq

    def _maybe_finish(self, seq: _Running,
                      finished: List[RequestOutput]) -> bool:
        reason = None
        if self.eos_token_id is not None and \
                seq.generated[-1] == self.eos_token_id:
            reason = "stop"
        elif len(seq.generated) >= seq.request.max_new_tokens:
            reason = "length"
        if reason is None:
            return False
        self.cache.release(seq.slot)
        self._free_slots.append(seq.slot)
        self._c["finished_requests"] += 1
        finished.append(self._finish_output(seq.request, seq.generated,
                                            reason, seq.ttft_s))
        return True

    def run(self) -> Dict[int, RequestOutput]:
        """Step until every request completes; {request_id: output}."""
        while self.has_work:
            self.step()
        return dict(self._outputs)

    @property
    def has_work(self) -> bool:
        return bool(self._queue or self._running or self._prefilling or
                    self._inflight is not None)

    @property
    def outputs(self) -> Dict[int, RequestOutput]:
        return dict(self._outputs)

    def stats(self) -> Dict[str, object]:
        """Plain counters (the reference's key names where the meaning is
        the same), the program counts, plus the pool and queue levels.
        Programs count as the reference's executables do: each built step
        program 1 (on the card, its captured graph), each eager bucket
        shape of the one-shot prefill 1; the unfused chunk program counts
        toward prefill.  Verify, copy and swap programs belong to later
        slices (0)."""
        built = {r for r, p in self._programs.items() if p.built}
        return {
            **self._c,
            "decode_executables": int(("fused" if self.fused else "decode")
                                      in built),
            "verify_executables": 0,
            "prefill_executables": len(self._seen_buckets) +
                                   int("chunk" in built),
            "copy_executables": 0,
            "swap_executables": 0,
            "graph_replays": sum(p.replays for p in self._programs.values()),
            "buckets": list(self.buckets),
            "prefill_chunk": self.prefill_chunk,
            "fuse": self.fused,
            "device": str(self.device),
            "pages_in_use": self.cache.pages_in_use(),
            "pages_free": self.cache.num_free_pages,
            "kv_token_capacity": self.cache.token_capacity(),
            "queued": len(self._queue),
            "prefilling": len(self._prefilling),
            "running": len(self._running),
            # the quantization knobs (None: full precision) and the pool's
            # at-rest bytes the capacity math is about
            "weight_dtype": self.weight_dtype,
            "kv_dtype": self.kv_dtype,
            "kv_pool_bytes": self.kv_pool_bytes(),
        }

    def kv_pool_bytes(self) -> int:
        """At-rest bytes of the device KV pool, every leaf (the scale lanes
        of an int8 pool too)."""
        return sum(t.numel() * t.element_size() for t in self._pool.values())


def pick_tokens(logits, greedy, noise, sampling) -> torch.Tensor:
    """[B, V] logits -> [B] int32 on the device: argmax, or the Gumbel pick
    under `noise` [B, V] with the greedy mask routing temperature=0.0
    requests to the argmax.  sampling: (sample, temperature, top_k)."""
    sample, temperature, top_k = sampling
    if not sample:
        return gpt_mod.sharded_argmax(logits)
    ids = gpt_mod.sample_token(logits, None, sample=True,
                               temperature=temperature, top_k=top_k,
                               noise=noise)
    return torch.where(greedy, gpt_mod.sharded_argmax(logits), ids)


# the step programs' bodies: (params, config, pool, sampling) bound by the
# engine, the static inputs by name


def _fused_body(params, config, pool, sampling, tokens, table, q_offset,
                valid, greedy, noise=None):
    sample, temperature, top_k = sampling
    out, _, _ = gpt_mod.serve_step_paged(
        params, tokens, pool, table, q_offset, valid, config, greedy=greedy,
        sample=sample, temperature=temperature, top_k=top_k, noise=noise)
    return out


def _decode_body(params, config, pool, sampling, tokens, table, lengths,
                 greedy, noise=None):
    logits, _ = gpt_mod.decode_step_paged(params, tokens, pool, table,
                                          lengths, config)
    return pick_tokens(logits, greedy, noise, sampling)


def _chunk_body(params, config, pool, sampling, tokens, table, q_offset,
                valid, greedy, noise=None):
    logits, _ = gpt_mod.prefill_chunk_paged(params, tokens, config, pool,
                                            table, q_offset, valid)
    return pick_tokens(logits, greedy, noise, sampling)


_BODIES = {"fused": _fused_body, "decode": _decode_body,
           "chunk": _chunk_body}
