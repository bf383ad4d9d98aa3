"""Continuous-batching serving engine — port of
`paddle_tpu/inference/engine.py::LLMEngine` in its fused configuration.

Paged KV pool (`models.gpt.init_paged_cache`) + per-slot page tables
(`inference.cache.PagedKVCache`), reservation admission, and ONE fused
program per steady-state step (`models.gpt.serve_step_paged`): decode slots
ride at valid=1, and in chunked mode (`prefill_chunk=N`) the oldest prompt's
next chunk rides the same batch at valid=chunk tokens.  Bucketed mode
(`prefill_chunk=None`, the default) prefills a whole prompt at admission
with one `prefill_paged` pass padded to a power-of-2 bucket.  Argmax,
temperature/top-k sampling (Gumbel noise from the engine's
`torch.Generator`) and the per-request greedy mask run on the device; the
host fetches only the [B, T] int32 token buffer.  With `double_buffer=True`
(default) that fetch happens at the top of the NEXT step, so the device
computes while the host schedules.

Knobs of later slices (prefix cache, speculative decoding, `fuse=False`,
optimistic admission and preemption, KV tiering, roles, fault injection,
int8, tensor parallelism, request tracing, injectable clocks) are accepted
only at their off values and raise `NotImplementedError` otherwise.
`prefix_cache` defaults to False here (True in the reference).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import gpt as gpt_mod
from .cache import PagedKVCache

_FP_NAMES = (None, "fp", "fp32", "f32", "bf16", "bfloat16", "float32")


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
    `models.convert.params_from_numpy`)."""

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
                 fuse: bool = True,
                 double_buffer: Optional[bool] = None,
                 admission: str = "reservation",
                 preempt: str = "recompute",
                 kv_tier: bool = False,
                 spill_dir: Optional[str] = None,
                 page_store=None,
                 role: Optional[str] = None,
                 fault_plan=None,
                 weight_dtype: Optional[str] = None,
                 kv_dtype: Optional[str] = None,
                 mesh=None, mp: Optional[int] = None,
                 seed: int = 0,
                 clock=None,
                 request_tracing: bool = False,
                 device=None):
        if prefix_cache:
            raise _later("prefix_cache=True", "prefix cache and COW copy")
        if spec_len:
            raise _later(f"spec_len={spec_len}", "speculative decoding")
        if not fuse:
            raise _later("fuse=False", "decode_step_paged and kernel 4")
        if admission != "reservation" or preempt != "recompute" or \
                fault_plan is not None:
            raise _later("optimistic admission, preempt='swap' and "
                         "fault_plan", "optimistic admission and preemption")
        if weight_dtype not in _FP_NAMES or kv_dtype not in _FP_NAMES:
            raise _later("int8 weight_dtype/kv_dtype", "int8 weights and KV")
        if mesh is not None or (mp is not None and mp > 1):
            raise _later("mesh/mp>1", "tensor-parallel serving")
        if kv_tier or spill_dir is not None or page_store is not None or \
                role is not None:
            raise _later("kv_tier, spill_dir, page_store and role",
                         "KV tiering, durable store and roles")
        if request_tracing or clock is not None:
            raise _later("request_tracing and clock",
                         "metrics, tracing and health")

        self.device = gpt_mod.resolve_device(device)
        if params["wte"].device != self.device:
            raise ValueError(f"params live on {params['wte'].device}, the "
                             f"engine on {self.device}")
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
        self.double_buffer = True if double_buffer is None \
            else bool(double_buffer)
        # the fused program's token width: the chunk lane in chunked mode,
        # a single decode token otherwise
        self._fused_T = prefill_chunk if self.chunked else 1
        self.cache = PagedKVCache(num_pages, page_size, num_slots,
                                  max_pages_per_slot)
        self._pool = gpt_mod.init_paged_cache(config, num_pages, page_size,
                                              device=self.device)
        self._queue: deque = deque()
        self._running: Dict[int, _Running] = {}
        self._prefilling: Dict[int, _Prefilling] = {}   # slot -> state, FIFO
        self._free_slots = list(range(num_slots - 1, -1, -1))
        self._ids = itertools.count()
        self._outputs: Dict[int, RequestOutput] = {}
        self._sample = bool(temperature and temperature > 0.0)
        self._temperature = temperature
        self._top_k = top_k
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        # the un-synced result of the last fused dispatch (double_buffer)
        self._inflight: Optional[Dict[str, object]] = None
        self._now = time.perf_counter
        self._c = dict.fromkeys(
            ("engine_steps", "decode_iterations", "decode_tokens",
             "fused_dispatches", "prefill_dispatches", "prefill_chunks",
             "prefilled_tokens", "admitted_requests", "finished_requests",
             "rejected_requests"), 0)

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

    def _pick(self, logits, greedy) -> torch.Tensor:
        """[B, V] logits -> [B] int32 on device: argmax, or a sample with
        the greedy mask routing temperature=0.0 requests to the argmax."""
        if not self._sample:
            return gpt_mod.sharded_argmax(logits)
        ids = gpt_mod.sample_token(logits, self._generator, sample=True,
                                   temperature=self._temperature,
                                   top_k=self._top_k)
        return torch.where(greedy, gpt_mod.sharded_argmax(logits), ids)

    # ---- scheduler --------------------------------------------------------
    def step(self) -> List[RequestOutput]:
        """One engine iteration: harvest the previous fused dispatch
        (double-buffered mode), admit queued requests into free slots, stage
        at most one prefill chunk (chunked mode), then dispatch ONE fused
        program over every decode slot and the chunk.  Returns the requests
        that finished this iteration."""
        finished: List[RequestOutput] = []
        self._harvest(finished)         # step n-1's tokens land first
        self._admit(finished)
        chunk_job = self._stage_chunk() if self.chunked else None
        if self._running or chunk_job is not None:
            self._fused_iter(chunk_job, finished)
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
            first = self._pick(logits, self._h2d([self._req_greedy(req)]))
            self._c["prefill_dispatches"] += 1
            self._c["prefilled_tokens"] += lp
            first = int(first[0])       # blocks on the result
            self._start_decoding(req, slot, first, finished)

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
        out, _, self._pool = gpt_mod.serve_step_paged(
            self.params, self._h2d(tokens), self._pool, self._h2d(table),
            self._h2d(qoff), self._h2d(valid), self.config,
            generator=self._generator, greedy=self._h2d(greedy),
            sample=self._sample, temperature=self._temperature,
            top_k=self._top_k)
        self._c["fused_dispatches"] += 1
        inflight = {"out": out, "slots": slots, "chunk": chunk_job}
        if self.double_buffer:
            self._inflight = inflight
        else:
            self._harvest(finished, inflight)

    def _harvest(self, finished: List[RequestOutput],
                 inflight: Optional[Dict[str, object]] = None) -> None:
        """Fetch the [B, T] token buffer of a fused dispatch (the step's only
        device->host transfer), emit each running slot's token, move a
        completed chunk's slot into the decode set, retire finishers."""
        inf = inflight if inflight is not None else self._inflight
        if inflight is None:
            self._inflight = None
        if inf is None:
            return
        out = inf["out"].cpu().numpy()          # blocks on the device result
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
        the same) plus the pool and queue levels."""
        return {
            **self._c,
            "buckets": list(self.buckets),
            "prefill_chunk": self.prefill_chunk,
            "device": str(self.device),
            "pages_in_use": self.cache.pages_in_use(),
            "pages_free": self.cache.num_free_pages,
            "kv_token_capacity": self.cache.token_capacity(),
            "queued": len(self._queue),
            "prefilling": len(self._prefilling),
            "running": len(self._running),
        }
