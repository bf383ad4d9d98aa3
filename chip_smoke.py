#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py            # one card, every phase
    python3 chip_smoke.py --tp       # four cards: the NCCL phases

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
               the timed call.  The paged prefill kernel also runs as a
               bucketed prefix-hit tail calls it (T 2048, one slot,
               q_offset 1000, 200 valid rows; fp at page 16, int8 at 32),
               and at the verify width of the fused spec step (row "1v":
               T = SPEC_LEN + 1, the prompt lengths as q_offset, drafted
               and undrafted slots in one batch, SPEC_VALID, two null-row
               slots; fp at page 16, int8 at 32).  Row "2c": the flash
               forward at a ring chunk of phase 12d (a), [1,2048,32,128]
               bf16, causal (the diagonal chunk) and not (an earlier
               rank's).
3. engine_bucketed — Llama-3-8B at full width (all 32 layers), bf16, random
               weights from a seeded generator, 8 greedy requests of 64-1024
               prompt tokens x 32 new tokens through `LLMEngine` with
               one-shot bucketed prefill (buckets 512, 1024 and 2048, so the
               prompts take two prefill programs, the reference's budget);
               the engine's decode-side program is warmed (`warm_decode`:
               its CUDA graph captured) before launch counts are zeroed, and
               the counts are read just after.  Every fused step and every
               one-shot prefill (one graph per bucket, built at its first
               use) is one graph replay (`graph_replays` = the dispatches,
               the replays adding their captures' launch counts), the
               program counts (`*_executables`) stay within
               `SERVE_PROGRAM_BUDGET` with one decode-side program, and the
               engine's memory (pool, graphs) is released when it is
               dropped.  The engine runs at its default `prefix_cache=True`;
               the random prompts share no prefix, and phases 3-6b fail on
               any prefix hit.
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
               the streams must be identical and the launch counts equal,
               and each bucket's prefill a graph in phase 3, eager here.
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
6c. engine_prefix — the prefix cache: a 1000-token system prompt (62 full
               pages of 16 and 8 tokens), a donor (it + 24 own tokens)
               served to its first token, then six requests together (the
               system prompt itself: a rolling-hash partial hit; its first
               992 tokens + a tail: a page-aligned hit; it + the donor's
               first 10 own tokens + a tail: a COW hit on the donor's own
               page; two tails of 17 and 200 tokens; an unrelated prompt
               missing into bucket 1024), and once the donor has finished
               its returning session (its prompt + 32 generated + 20 new
               tokens: a hit on the finish-time registration); 32 new tokens
               each, fused bucketed (the tails through the 2048-wide chunk
               program), fused chunked (`prefill_chunk=16`), `fuse=False`
               bucketed, and int8 fused bucketed at page 32.  Each request's
               cached tokens equal the page geometry's, the hit and COW
               counts the plan's, launches 32 x the dispatches on the pool's
               lane, graph replays the dispatches, one copy and at most two
               prefill programs, 0 pages in use after the drain, the
               cache's invariants hold, and each hit request's first token
               equals the dense `forward`'s argmax over its prompt where
               the margin exceeds 0.05.  Beside them, the same traffic
               without the cache: prefilled tokens, TTFT per request,
               tokens/s and step ms.
6d. engine_spec — speculative decoding (`spec_len=SPEC_LEN`) on prompts
               that repeat: each request a seeded SPEC_PATTERN-token
               pattern tiled to the PROMPT_LENS lengths, 32 new tokens.
               First spec off (the baselines: bf16 bucketed and chunked,
               int8, and float32, the bf16 weights computed in f32); then
               the n-gram proposer on the same traffic (its hits and the
               spec counters reported, not required: with random weights
               no token of a greedy stream recurs, so it drafts nothing);
               then drafts replayed from the spec-off streams
               (`step_profile.ReplayProposer`, a draft model that is right
               until the stream leaves the baseline's at a near-tie): bf16
               fused bucketed (the fused step SPEC_LEN + 1 rows wide),
               fused chunked (`prefill_chunk=16`), `fuse=False` bucketed
               (the verify program beside the decode program), int8 fused
               bucketed at page 32 (SPEC_INT8_REQUESTS requests), and f32
               fused and unfused bucketed.  Each: tokens/s, step ms, decode
               iterations, graph replays, the spec counters and the
               proposer's; `spec_events` > 0 in the replay modes; graph
               replays = dispatches; decode-side programs 1 fused (within
               the budget), 2 unfused (decode + verify, outside it as in
               the reference); paged prefill launches 32 x (fused + chunk +
               verify dispatches), paged decode 32 x decode dispatches, on
               the pool's lane, no composed call.  Lossless: every token of
               requests 0 and 1 against the dense `forward`'s argmax over
               prompt + generated (over the dequantized weights for int8;
               its last hidden states' logits in f32), the positions that
               differ listed with their top-2 margins; in f32 none may have
               a margin above 0.05; in bf16 and int8 they are reported
               beside the spec-off engine's own (the bf16 engine's rounding
               flips tokens of the random model at margins up to ~0.12
               with spec off too).  Agreement with the spec-off streams
               printed, not required.
6e. engine_overload — optimistic admission and preemption under memory
               pressure, the PROMPT_LENS traffic x 32 new tokens: (a) fused
               chunked (`prefill_chunk=16`), default pool, recompute,
               `FaultPlan(pressure_steps=OVERLOAD_PRESSURE)` at steps where
               two or three slots decode while a prompt is mid-chunk; (b)
               fused bucketed, 212 real pages, swap, requests 0 and 1 at the
               lowest priorities, so that one growth pass preempts both;
               (c) the same with `fuse=False`; (d) int8 weights and KV at
               page 32, OVERLOAD_REQUESTS requests, 20 real pages, swap;
               (e) float32, OVERLOAD_REQUESTS requests, 40 real pages,
               recompute (a prefix hit: the 2048-wide chunk program), beside
               their f32 reservation run.  Each: the cache's invariants
               after every step (outside the step times), preemptions > 0,
               0 pages in use and 0 swapped after the drain, launches 32 x
               the dispatches on the pool's lane, graph replays = the
               dispatches + the swap replays, the programs within the
               budget, no composed call; in the swap modes swaps > 0, 2
               swap programs, streams bitwise equal to the undisturbed runs
               of phases 3, 5 and 6b; a step with two victims in (b) or
               (c); (e) equal to its reservation run.  Reported: tokens/s
               and median step ms beside the undisturbed run's, the
               overload counters, one "swap_out" and one "swap_in" replay's
               device ms and the pinned d2h ms a page, (a)'s bf16 agreement
               with phase 4 and the forward's margin where each stream
               leaves it, and the KV tier's counters (phases 3-6e run at
               the engine's default `kv_tier=True`).
6f. engine_tier — the KV tier, the durable store and the roles, on
               multi-turn sessions: wave 1 the PROMPT_LENS prompts x 32,
               wave 2 (the flush) 8 fresh seeded prompts of the same
               lengths x 32, wave 3 the returning turns (each wave-1 prompt
               + its reply + TIER_FRESH fresh tokens) x 32.  (a) fused
               chunked (`prefill_chunk=16`), 280 real pages (one wave at a
               time), the host tier (a host pool of 1024 pages), beside a
               never-evicting pool (1024 pages, waves 1 and 3) and the same
               280-page run with `kv_tier=False` (re-prefill); (b) fused
               bucketed: a `role="prefill"` engine on a temporary
               `spill_dir` serves wave 1, `export_prefix`es each
               conversation and is dropped, a `role="decode"` engine on the
               directory (store nodes merged at init) serves wave 3 from
               the store level, beside a never-evicting bucketed pool; (c)
               int8 weights and KV at page 32, TIER_INT8_REQUESTS sessions,
               36 real pages, host tier, beside a never-evicting pool.
               Each: the cache's invariants after every step (off the step
               times), wave-1 and wave-3 streams and cached tokens bitwise
               equal to the never-evicting pool's (the restored KV is the
               same bytes, into the same programs), spills and restores in
               (a) and (c), 8 exports and store restores in (b), the
               int8 restore carrying all four pool leaves, one "swap_in"
               replay a restore, at most 2 swap programs and the programs
               within the budget, launches 32 x the dispatches on the
               pool's lane, no composed call, 0 pages in use after the
               drain and the host tier within its pool.  Reported: each
               wave's TTFT (median, max), prefilled tokens and tokens/s for
               the tier run, the baseline and the re-prefill run, the tier
               and handoff counters, a restore's staging ms and the
               "swap_in" replay's device ms, the npz write and read ms a
               page, the card's name and power limit.
6g. engine_obs — metrics, tracing and health: phase 3's engine (fused
               bucketed, `request_tracing=True`, the default) warmed on a
               first pass of fresh prompts of the PROMPT_LENS lengths and
               reset (`reset_counters`), then the phase-3 prompts inside
               `engine.trace(dir, device=True)`: `host_trace.json` holds
               the engine.step, admit, prefill.dispatch, fused.dispatch and
               sample.sync spans, `step_timeline.json` one v2 record a
               step (at most one dispatch each), `metrics.json` and the
               Prometheus text parse line by line, the `torch.profiler`
               trace in `device/` holds CUDA kernel events and names the
               paged prefill kernel (on an `_eager=True` engine if the
               graph replays' kernels go unnamed), `stats()["latency"]`
               counts 8 TTFTs and e2e times, each request has queue <=
               TTFT <= e2e and 32 tokens and a timeline enqueue ...
               first_token ... finish, no steady-state recompile, the
               programs within the budget, a health state neither
               "error" nor "overloaded"; then the same prompts on an
               engine with `request_tracing=False`, no window: bitwise the
               same tokens and program counts.  The step's wall and its
               host share (the step less its wait in engine.sample.sync),
               median and mean over the steady fused steps, tracing off /
               on / on / off on fresh prompts, and the on/off ratio
               (reported, not a gate).  A dropped engine is freed at `del`
               without the collector, and the phase's engines leave at
               most RELEASE_SLACK.  Then a 2-layer engine of the same width
               under a `FaultPlan` of forced pool pressure (optimistic
               admission, recompute): health leaves "ok" on the preemption
               signal and the `engine_health` gauge reads its code.  The
               traced pass's launches join the kernels line; the card's
               name and power limit are printed.
6h. engine_fleet — the engine fleet and the front door: Llama-3-8B at full
               width, bf16, phase 3's bucketed knobs for every replica, one
               set of weights.  (a) seven sessions (the first seven phase-3
               prompts x 32, then each prompt + reply + 64 seeded tokens x
               32) through `start`, `submit`, `result`, `drain` of three
               fleets: one replica (affinity), two (affinity), two (round
               robin).  Turn 1 bitwise equal in the three, turn 2 bitwise
               equal in the two affinity fleets, whose turn-2 cached tokens
               are each session's turn-1 KV (prompt + reply - 1); round
               robin's are 0, its turn 2 and affinity's held against the
               dense forward's first token where the top-2 margin exceeds
               0.05 (ties printed).  The replicas run on the leader's
               parameter tensors (`shared_executables()`), two replicas
               grow `memory_allocated` by less than half a copy of the
               weights, each replica's programs within the budget but for
               the prefill key (reported: two buckets and the hit-tail
               program, as one engine builds on the same traffic) and none
               above the one-replica fleet's.  Printed: each fleet's
               tokens/s, turn-2 TTFT median and max, the median wall of
               `EngineFleet.select` while the loops run.  (b) replica 0
               decodes 512 tokens in its loop while replica 1 prefills a
               1500-token prompt, capturing bucket 2048 in its loop; then
               a fleet whose replica 0 serves four requests under
               optimistic admission with swap preemption and forced
               pressure while replica 1 captures the same bucket: every
               stream equal to the same requests run alone on the
               one-replica fleet, no capture or step raising.  (c)
               `roles="P:D"` over one store directory, the turn-1
               sessions: 7 handoffs (p50/p99 ms printed), the decode
               replica's cached tokens covering each prompt's full pages,
               first tokens held by the margin rule.  (d) `ServingFrontend`
               over (a)'s two-replica affinity fleet on loopback: a
               completion and an SSE chat (its client-side time to the
               first frame printed) whose tokens equal `fleet.result` of
               the same prompt from the same cached prefix, a client
               dropped mid-stream (aborted, pages back to the count
               before it), OpenMetrics `/metrics` with `llm_fleet_*` and
               `/healthz` through the same port.  No composed route; rows
               1, 2 and 3 launch, none of the paged decode kernel; the
               phase's engines leave at most RELEASE_SLACK.  The card's
               name and power limit are printed.
6i. engine_tp — tensor-parallel serving (`LLMEngine(mesh=)` over
               `parallel.tp.serving_mesh`): two ranks on this one card
               (gloo, so eager; the workers and a 4-rank mesh started
               together), Llama-3-8B at full width cut to TP_LAYERS = 4
               layers (phase 3's first 4; the phase took 228.5 s at 32,
               118.7 s at 8 in the first smoke with phase 8c),
               bf16, the phase-3 prompts x 32 at mp 2, fused bucketed,
               fused chunked
               (`prefill_chunk=16`) and `fuse=False`.  Every rank's counts
               are zeroed just before and read just after: each rank
               launches row 1 exactly layers x (fused + chunk + verify
               dispatches), row 4 layers x decode dispatches, row 2
               layers x bucketed prefills, nothing composed; each rank's
               pool is
               half of mp=1's (`rank_pool_bytes`); the programs within the
               budget; every first token the dense forward's where the
               top-2 margin exceeds 0.05 (ties printed).  Then float32 at
               TP_F32_LAYERS layers, spec decoding (SPEC_LEN) and the prefix
               cache on, chunked, repeating prompts and two that share 512
               tokens: greedy streams byte-equal at mp 1, 2 and 4.  Rows 1
               (T 1 and 16), 2 ([1,1024,H,128]) and 4 at a rank's heads
               (H16 KVH4 at mp 2, H8 KVH2 at mp 4; bf16, and f32 at mp 2)
               against their plain versions, with times and bounds.  Times
               here are two ranks time-slicing one card with their
               all-reduces through host memory: not a tensor-parallel time.
               `python3 chip_smoke.py --tp`, on four cards: the device
               phase, then only `engine_tp_nccl`, `engine_fleet_tp_nccl`,
               `host_copy_tp` and `train_nccl` (12b).  `engine_tp_nccl`:
               NCCL meshes of 2 and 4
               ranks, fused bucketed and chunked at mp 1, 2 and 4 on CUDA
               graphs (NCCL collectives captured) and eagerly on the same
               mesh: streams and every rank's pool bitwise equal, one
               replay a dispatch on every rank, the launch counts as
               above, step ms and tokens/s; f32 streams equal at mp 1, 2
               and 4.  `engine_fleet_tp_nccl` ((a), all 32 layers): two
               pre-built mp 2 engines on cards 0-1 and 2-3 behind one
               fleet (dp 2 x mp 2), and two replicas on one mp 4 mesh:
               6j's sessions stepped replica by replica with the loops
               stopped, on graphs and eagerly, give the same streams and
               every rank's pool bitwise; then through the loops,
               tokens/s and turn-2 TTFT beside one mp engine's.
               `host_copy_tp` ((d)): engine_overload (b)'s
               swap traffic and engine_tier's spill waves at mp 1, 2 and
               4, graphs: the steps that queue a gather to the host, that
               stage from it, both or neither, the host-copy ms a
               page moved, and under mp the host slabs' bytes.
6j. engine_fleet_tp — two replicas on phase 6i's mp 2 gloo mesh
               (eager), the first TP_LAYERS layers of phase 3's weights,
               built from `engine_kwargs=dict(mesh=)`: the worker holds
               one weight shard (`weight_bytes`) and a pool shard a
               replica; (a) phase 6h's seven two-turn sessions, affinity:
               every request finishes, the returning turns reuse their
               whole turn-1 KV, each rank launches row 1 layers x both
               replicas' fused and chunk dispatches and row 2 layers x
               their bucketed prefills, nothing composed; (b) the front
               door over that fleet (6h (d)); (c) `roles="P:D"` at mp 2,
               two handoffs through the store; (d) float32 at
               FLEET_TP_F32_LAYERS layers: every stream of the two
               replicas equals the same requests on one mp 1 engine.
7. first_token — the first tokens of phases 3, 4 and both modes of 5 for
               two prompts against the argmax of the dense `forward` at the
               last prompt position, held equal where the top-2 margin
               exceeds 0.05 (ties printed).
8. decode_logits — one `prefill_paged` of prompt 0, then `decode_step_paged`
               on its greedy next token: argmax equal to the dense
               `forward`'s over prompt + token where the margin exceeds 0.05.
8b. generate — dense KV-cache `generate` at Llama-3-8B width on phase 3's
               bf16 weights: 8 seeded prompts of 512 tokens x 32 new; the
               first call captures the prefill and the decode step as CUDA
               graphs, the second (counted) replays them (`compiles` kept,
               32 replays) and equals the first; first tokens against the
               dense forward's argmax where the top-2 margin exceeds 0.05
               (ties printed); an EOS case stays frozen; tokens/s, the
               decode step's ms, rows 2 and 3's launches.  Then float32
               (TF32 off) at Llama-3-8B width with 2 layers: `generate`'s
               tokens against the fused bucketed engine's streams for the
               same prompts, equal but for ties (F32_TIE).
8c. layer_api — the eager Layer API at Llama-3-8B full width (all 32
               layers), bf16, on the card: `paddle_tpu_torch.seed(0)`, then
               `models.GPTForCausalLM(llama3_8b)` (its parameter count and
               bytes printed); `model(ids)` under `no_grad` on 4 seeded
               prompts of 512 tokens, `loss = model(ids, labels)`,
               `loss.backward()`, and `model.generate(ids[:, :64],
               max_new_tokens=32)`, with the kernel counts zeroed just
               before and read just after: rows 2 and 3 exactly layers x
               the forward calls (two, and generate's prefill for row 2 and
               its 32 picks for row 3, as the functional path launches
               them), rows 5 and 6 layers once, nothing composed.  Then the
               functional path on the same tensors (`model.params_pytree()`,
               not counted): the logits bitwise `forward`'s, the loss
               bitwise `loss_fn`'s, every `Parameter.grad` bitwise
               `torch.autograd.grad` of `loss_fn` (a leaf the loss does not
               read has no grad in either; any that differ are printed in
               the failure), the tokens bitwise the functional
               `generate`'s (its program captured anew), and the first new
               tokens the dense forward's argmax where the top-2 margin
               exceeds 0.05 (ties printed).  Peak memory, the phase's
               seconds and the card's name and power limit are printed.
8d. ops_api — the op namespace (`ops/`, `paddle.*`, `paddle.linalg`) on
               the card, kernel counts zeroed before.  (a) Every case of
               the CPU twin tables (`tests/torch_op_cases.py`: the sweep,
               math, breadth and trouble-spot cases) with
               `set_device("gpu:0")` against the same port call with
               `set_device("cpu")`: outputs on the card, float values and
               gradients within the case's tolerance, integer, bool and
               index outputs equal; creation and random ops land on the
               card, `paddle.seed(s)` repeats a draw, another seed changes
               it, `uniform(seed=k)` stands apart from the global state.
               (b) 8c's logits [4, 512, 128256] bf16 (all 32 layers of
               Llama-3-8B, kept from 8c, not recomputed): the shifted-label
               loss composed from `cast`, `logsumexp`, `take_along_axis`,
               `where`, `sum` within OPS_LOSS_REL of 8c's `loss_fn` value;
               `paddle.grad` of it w.r.t. a float32 copy of the logits
               within OPS_GRAD_TOL of (softmax - one-hot) / count;
               `argmax(logits[:, -1])` equal to `picks_and_margins`' picks
               (at a bf16 tie at the top, the first tied index); 32 draws a
               row by top-k 50 / top-p 0.9 (`topk`, `sort`, `cumsum`,
               `exp(x - logsumexp)`, `multinomial`), every token inside its
               row's top-p set (by value, from torch alone) and repeated
               under one seed.  No kernel launch and no composed route;
               seconds, peak memory, the card's name and power limit.
8e. nn_api — `nn/` on the card, kernel counts zeroed before.  (a) Every
               case of the nn CPU twin tables (`tests/torch_nn_cases.py`)
               with `set_device("gpu:0")` against the same port call with
               `set_device("cpu")` (floats and gradients within the case's
               tolerance, integer outputs equal), and the drawing
               functions repeated under one seed on the card.  (b) At
               BERT-base width (the repo's `bert_base` preset: D 768, 12
               heads of 64, FFN 3072, 12 layers, vocab 30522), bf16, after
               `paddle_tpu_torch.seed(0)`: `nn.Embedding`, a post-LN
               `nn.TransformerEncoder` (gelu, dropout 0) and an `nn.Linear`
               head on B 16 x S 512 seeded ids, `F.cross_entropy` with
               `ignore_index=-100` on the 85% of positions left unlabeled,
               `loss.backward()`: the counts zeroed just before and read
               just after, rows 2, 5 and 6 exactly 12 each, nothing
               composed, a finite loss and a grad on every parameter;
               then, uncounted, the same pass timed three times with the
               in-place version check and three times with it a no-op,
               alternating, and the `apply` calls a pass makes.
               (c) The same stack in float32 (TF32 off), once through the
               kernels and once with an all-true bool `attn_mask` (the
               plain route: exactly 12 composed calls): logits, loss and
               every parameter's grad within BWD_F32_REL * max(1,
               max|ref|); the largest difference printed.  (d) Over 8c's
               logits [4, 512, 128256] bf16 (kept from 8c):
               `F.cross_entropy` of the shifted labels within OPS_LOSS_REL
               of 8c's `loss_fn` value, and `F.softmax(dtype="float32")`
               rows summing to 1 within NN_SOFTMAX_TOL.  Seconds, peak
               memory, the card's name and power limit.  (a) runs the
               conv, pooling, vision and sparse-op cases too.
8f. nn_train — `paddle.optimizer` on the card.  (b) 8e's bf16 stack and
               batch, NN_TRAIN_STEPS steps of the pass, `opt.step()`,
               `opt.clear_grad()` and `sched.step()` with
               `optimizer.AdamW(weight_decay=0.01,
               grad_clip=nn.ClipGradByGlobalNorm(1.0))` over
               `lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, T_max=6),
               2, 0.0, 1e-3)`: the counts zeroed before each step and read
               after it, rows 2, 5 and 6 exactly 12 each, nothing
               composed; `opt.step()` under the sync debug mode "error"
               (no host read) and between CUDA events; the learning rates
               read each step equal to the scheduler's Python sequence;
               every parameter's moment1 and moment2 float32 on the card;
               the mean of the last two losses below the first.  Losses,
               step ms, the optimizer's device ms, accumulator bytes, peak
               memory.  (c) A 2-layer stack in float32 (TF32 off), one
               pass on the card, its parameters and grads copied to the
               port on the CPU, one AdamW step (the clip, the schedule one
               step in) on each: every parameter, moment1 and moment2
               within OPT_F32_REL * max(1, max|cpu|).  (d) In bf16, one
               forward, backward and `Momentum` step each of ResNet-50's
               stem and stage 1 (B 32 x 3 x 224 x 224), `nn.LSTM(1024,
               1024, num_layers=2)` (B 32 x T 64) and a gshard top-2
               `MoELayer` of 8 `nn.Linear(2048, 2048)` experts on 8192
               tokens (its dropped assignments by
               `dispatch.capacity_slots`): a finite loss, a grad on every
               parameter, no kernel launch and no composed call; seconds
               and peak memory each.
9. kernels_bwd — the flash backward pair (dkv and dq kernels) against
               `_flash_bwd_ref` at [1,1024,32,128] causal, the training
               shape [4,2048,16,128] causal and [2,333,8,64] full, in bf16
               and float32: max abs errors, dkv/dq/pair/plain ms, the
               backward alone of SDPA as the library yardstick, bounds, the
               body that ran (`body`: `wgmma` for the dense bf16 pair at D 64
               and 128, `BWD_BODY`), and at the training shape two calls'
               dq, dk, dv bitwise equal; rows "5c, 6c": the pair at a ring
               chunk of phase 12d (a), [1,2048,32,128] bf16, causal and
               not; then RMSNorm's dx, dw through its autograd Function
               against autograd through `_rms_ref`.
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
12b. train_mesh — data, ZeRO and tensor-parallel training on this one card:
               four ranks of a `parallel.tp` mesh (gloo, which stages its
               collectives of CUDA tensors through host memory).  (a) GPT-3 1.3B
               (TRAIN_MESH_LAYERS = 8 layers; the run took 68.6 s at all
               24) in bf16 with bf16 moments and
               remat, B=4, S=2048, `MeshConfig(dp=2, mp=2, sharding_stage=1,
               sequence_parallel=True)`, 1 warm-up and 2 timed steps:
               finite, falling losses, step 0 near ln V, each rank's
               kernel counts zeroed just before and read just after (rows
               2, 5 and 6 exactly layers x steps on every rank at the rank's
               [2,2048,8,128], nothing composed), each rank's peak memory,
               tokens/s and the collectives a rank makes a step with their
               bytes.  (b) float32 (TF32 off) at GPT-3 1.3B width with 2
               layers, B=4, S=1024, 3 steps from the same weights at mp 1
               (one device), `(dp 2, mp 2, ZeRO-1)` and `(sharding 2, mp 2,
               ZeRO-3, sequence_parallel)`: losses and the gathered
               parameters within 1e-4 (relative for the losses, rtol and
               atol for the parameters).  (c) rows 2, 5 and 6 at the rank's
               shape [2,2048,8,128] causal bf16 against their plain
               versions, with kernel, plain, SDPA and bound times.  Times
               here are four ranks time-slicing one card: not a parallel
               training time.  `python3 chip_smoke.py --tp` adds
               `train_nccl` on four cards: the same GPT-3 1.3B training at
               dp 4 (ZeRO-1), mp 4 and dp 2 x mp 2 with sequence
               parallelism under NCCL, beside mp 1 on one card, then
               phase 12c's pp 4 (B 8, M 8) and MoE pp 2 x ep 2: losses,
               tokens/s, step ms, each rank's peak memory and collectives;
               then (b) cp 4 and dp 2 x cp 2 (the ring over NCCL: its
               sends, bytes and launches held to the formula as in 12d)
               with float32 cp 4 parity against one device at 12d (b)'s
               shape, and (c) 12c's pp 2 x vpp 2 x mp 2, whose links close
               a cycle.
12c. train_pp — pipeline and expert-parallel training on this one card:
               four gloo ranks (gloo stages the collectives of CUDA
               tensors through host memory itself, the port its send/recv,
               counted as "<group>.send_host"/"recv_host").  (a) GPT-3 1.3B
               (TRAIN_PP_LAYERS = 4 layers: the phase passed 180 s at all
               24, and 213.3 s at 8 in the first smoke with phase 8c),
               bf16 with bf16 moments, remat,
               B=8, S=2048, at `MeshConfig(pp=4, micro_batches=8)` and
               `(pp=2, vpp=2, mp=2, micro_batches=4)`, 1 warm-up and 2
               timed steps each: finite, falling losses, step 0 within
               0.01 of one device's loss on the same weights and batch
               (phase 12's weights at this depth; phase 12's own step 0,
               at 24 layers and B 4, is reported beside it), rows
               2, 5 and 6 exactly (layers a stage) x M x steps
               on every rank, nothing composed, each rank's peak memory,
               tokens/s, the point-to-point calls and bytes a rank makes a
               step (`p2p_per_step`) and the schedule's bubble share
               (pp - 1) / (vpp * M + pp - 1).  (b) `moe_config()` at
               `(pp=2, ep=2, micro_batches=2)`, B=4, S=2048, 1 warm-up and
               3 timed steps (its loss rises at step 1, as phase 14's
               does): the same checks and the all-to-all calls and bytes a
               rank makes.
               (c) float32 (TF32 off), 3 steps from the same weights, B=8,
               S=1024: GPT-3 1.3B width at 4 layers on one device against
               pp 4 (M 4) and pp 2 x vpp 2 x mp 2 (M 4); the MoE width at 4
               layers with capacity factor 8 and aux weight 0 (no drops;
               the reference's setting for ep against one device), remat,
               against pp 2 x ep 2 (M 2): losses within 1e-4 relative,
               gathered parameters within 1e-4 (dense: element by element;
               MoE: each leaf in relative norm, since a top-2 near-tie
               that rounding flips moves the elements its token reaches;
               those past 1e-4 are reported, and so is every token whose
               top-2 experts differ from one device's, with its margin,
               from the router's logged choices).  (d) rows 2, 5 and 6 at
               a stage's [1,2048,16,128] causal bf16 against their plain
               versions,
               with kernel, plain, SDPA and bound times.  `--tp` adds (a)'s
               pp 4 and (b) to `train_nccl`.
12d. train_cp — context-parallel training on this one card: four gloo
               ranks, the ring's send/recv host-staged as pp's.  (a)
               Llama-3-8B at full width (D 4096, 32 heads, 8 kv heads,
               FFN 14336, vocab 128256), TRAIN_CP_LAYERS = 2 layers, bf16
               with bf16 moments and remat, B=1, S=8192 at
               `MeshConfig(cp=4)`, 1 warm-up and 2 timed steps: step 0
               within 0.01 of one device's loss on the same weights and
               batch (reported beside ln V + (0.02^2 D) / 2, random
               logits' expectation), finite, falling losses, rows 2, 5
               and 6 exactly layers x (c + 1) a step on cp rank c (the
               chunks it sees),
               nothing composed, each rank's peak memory, tokens/s, and the
               ring's sends and bytes a rank a step held to the formula of
               `parallel/ring_attention.py` (`ring_traffic`).  (b) float32
               (TF32 off), GPT-3 1.3B width (learned positions) at 2 layers,
               B=4, S=2048, 3 steps from the same weights on one device,
               at cp 4 and at dp 2 x cp 2: losses within 1e-5 relative,
               gathered parameters within 1e-4 element by element.  (c)
               `ring_attention` forward and backward at cp 4 on the ranks
               ([1,8192,32,128] q, 8 kv heads), bf16 and float32, against
               plain single-device attention.  `--tp` runs cp over
               NCCL in `train_nccl` (12b).
12e. engine_ckpt — `distributed.auto_parallel.Engine` at GPT-3 1.3B width,
               2 layers, float32, B=4, S=2048, on four gloo ranks:
               `fit` 3 steps on dp 2 x mp 2, `save` (the reference's
               layout, under the checkout's git-ignored build/) and 3 more
               steps (the uninterrupted curve), then resumed from
               another init on dp 4, on mp 2 and on cp 2, 3 steps each:
               losses within 2e-4 relative of the curve's last 3; save and
               load seconds and the checkpoint's bytes; on cp 2 `predict`'s
               logits (the dense forward) give `evaluate`'s loss (the
               ring) within 1e-4.
13. engine_moe — the MoE family at the GPT-3 1.3B trunk (`gpt3_1p3b` with 4
               experts, top-2, capacity factor 2 in every block; ~3.7 B
               parameters), bf16, seeded random weights: phase 3's bucketed
               engine on the 8 prompts (`serve`), first tokens against the
               dense forward, one fused-step replay bitwise its eager body
               (tokens and pool pages 1 and up), the int8-weight engine
               (experts and gate unquantized) against the forward over its
               dequantized weights, and the dropped assignments of a decode
               step's 8 rows and a 512-token prefill.
14. train_moe  — the same config through `HybridParallelTrainer` as phase
               12 (bf16 params and moments, remat, B=4, S=2048, 1 warm-up
               and 4 timed steps): finite, falling losses, the aux, peak
               memory, tokens/s.
15. bert       — `bert_base` (post-LN, non-causal, hd 64, MLM head), bf16,
               B=16, S=512, 4 trainer steps: finite, falling losses, rows 2,
               5 and 6 on the kernel route; float32 (TF32 off) `loss_fn`
               and its grads through the kernels against plain attention;
               rows 2, 5 and 6 at the encoder shape [16,512,12,64]
               non-causal against their plain versions, with times.

Then one line `{"kernels": [...]}` for all nine kernels and the int8 lanes of
the two paged ones (launches summed over the main-path runs of phases 3, 4,
5, 6b, 6c, 6d, 6e, 6f (its tier runs), 6g (its traced pass), 6h (its
fleets), 6i (its bf16 runs, every rank's launches), 8b (its counted bf16
call), 8c (the Layer API's calls), 8d (none: the ops launch no
kernel), 8e ((b), the BERT-base nn stack), 8f ((b), its six steps), 10, 11, 12, 12b ((a), every rank's launches), 12c ((a) and (b),
every rank's launches), 12d ((a), every rank's launches), 12e (the
Engine's fit and resumed steps, every rank's launches), 13 (bf16 and
int8), 14 and 15, each with the counts zeroed just before it and read
just after; none
of them may take an entry's composed route for shapes the kernels do not
take) and, last,
`{"ok": true, "device": ...}`.
Exits non-zero, with no result line, without CUDA, outside the repository,
or when any phase fails.
"""
import copy
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
# step_profile.py --window keeps a copy of these two: change them together
PROMPT_LENS = (64, 96, 160, 256, 384, 512, 768, 1024)
SERVE_BUCKETS = [512, 1024, 2048]       # the prompts take two of them
# the paged prefill kernel as the bucketed prefix-hit tail calls it: one
# slot, T = the largest bucket, a match ending mid-page, the longest tail of
# the engine_prefix traffic
TAIL_T, TAIL_OFFSET, TAIL_VALID = 2048, 1000, 200
INT8_PAGE = 32          # the int8 engines' page (the reference's int8 gate)
# speculative decoding (engine_spec): the reference's test value, so the
# fused bucketed step and the verify program are SPEC_LEN + 1 wide; each
# prompt a seeded SPEC_PATTERN-token pattern tiled to PROMPT_LENS
SPEC_LEN, SPEC_PATTERN = 4, 16
# requests of 6d's int8 modes: 4, cut from 8 when the smoke with 6d ran
# past the time the smoke took before it (PERF.md)
SPEC_INT8_REQUESTS = 4
# row 1 at the verify width: the fused spec step's valid per slot (1: no
# draft), slots 6 and 7 inactive (null table row, offset 0)
SPEC_VALID = (5, 1, 5, 3, 1, 5, 1, 1)
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


def flash_case(dtype, dev, shape, causal=True):
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.incubate.kernels.flash_attention import (
        FWD_BODY, _flash_fwd_ref, flash_attention_fwd)
    B, S, H, D = shape
    rng = np.random.RandomState(S)
    q, k, v = (torch.from_numpy(rng.randn(B, S, H, D).astype(np.float32))
               .to(dev, dtype) for _ in range(3))
    scale = 1.0 / math.sqrt(D)
    out, lse = flash_attention_fwd(q, k, v, causal, scale)
    ref, ref_lse = _flash_fwd_ref(q, k, v, causal, scale)
    err = check_close("flash_attention", out, ref, dtype)
    lse_err = float((lse - ref_lse).abs().max())
    if lse_err > 1e-3:
        raise AssertionError(f"flash lse disagrees: {lse_err:.3g}")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    isz = q.element_size()
    # causal: keys <= row
    flops = 4 * B * H * D * (S * (S + 1) // 2 if causal else S * S)
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    b, by = bound(4 * B * S * H * D * isz + B * H * S * 4, flops, peak)
    return {
        "kernel": "flash_attention_fwd", "S": S, "shape": [B, S, H, D],
        "causal": causal, "body": FWD_BODY[dtype], "max_abs_err": err,
        "lse_max_abs_err": lse_err,
        "kernel_ms": time_ms(lambda: flash_attention_fwd(q, k, v, causal,
                                                         scale)),
        "plain_ms": time_ms(lambda: _flash_fwd_ref(q, k, v, causal, scale)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal)),
        "bound_ms": b, "bound_by": by}


def paged_inputs(dtype, dev, T, page=16, heads=(32, 8)):
    """H=32, KVH=8 (or `heads`), hd=128, 2048 tokens a table row.  T 1
    and 16: B=8, mixed q_offset/valid, slots 6 and 7 null-table slots
    (valid 1, offset 0);
    T = SPEC_LEN + 1: the fused spec step, the smoke's prompt lengths as
    q_offset of slots 0-5 and SPEC_VALID (drafted and undrafted slots),
    slots 6 and 7 null-table slots; T = TAIL_T: the bucketed prefix-hit
    tail, one slot at q_offset TAIL_OFFSET (mid-page) with TAIL_VALID valid
    rows."""
    import torch
    rng = np.random.RandomState(T)
    (H, KVH), hd, max_pages = heads, 128, 2048 // page
    if T == 1:
        q_offset = np.array([0, 37, 300, 1000, 1500, 2040, 0, 0])
        valid = np.ones(8, np.int64)
    elif T == TAIL_T:
        q_offset, valid = np.array([TAIL_OFFSET]), np.array([TAIL_VALID])
    elif T == SPEC_LEN + 1:
        q_offset = np.array([*PROMPT_LENS[:6], 0, 0])
        valid = np.array(SPEC_VALID)
    else:
        q_offset = np.array([0, 37, 300, 1000, 1500, 63, 0, 0])
        valid = np.array([16, 5, 16, 1, 9, 16, 1, 1])
    B = len(valid)
    real = min(B, 6)                    # the slots with table rows
    table = np.zeros((B, max_pages), np.int32)
    need = [-(-(q_offset[b] + valid[b]) // page) for b in range(real)]
    P = 1 + sum(need)
    perm = list(rng.permutation(np.arange(1, P)))
    for b in range(real):
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


def paged_case(dtype, dev, T, page=16, int8=False, heads=(32, 8)):
    """The paged prefill kernel against its plain version; `int8`: its int8
    lane over the int8 pool `_quantize_kv` makes of the same inputs;
    `heads`: (H, KVH), a tensor-parallel rank's (engine_tp)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.incubate.kernels import paged_attention as PA
    from paddle_tpu_torch.incubate.kernels.paged_attention import (
        _prefill_split_plan, paged_prefill_attention_kernel,
        paged_prefill_attention_ref)
    args, q_offset, valid = paged_inputs(dtype, dev, T, page, heads)
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
    # what this data needs: q of the valid rows only, every output row
    # (padding rows are written 0), each slot's keys up to its last real
    # query (K and V rows, with their f32 scales for an int8 pool), each
    # valid row's causal span; the int8 lane's math is f32 (the
    # reference's lane)
    keys = sum(int(q_offset[b] + valid[b]) for b in range(B))
    rows = sum(int(n) for n in valid)
    row = hd + 4 if int8 else hd * isz
    nbytes = ((rows + B * T) * H * hd * isz + 2 * keys * KVH * row
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
          int8=False, spec_len=0, proposer=None, overload=None):
    """Warm up on one short request, build the engine and warm its
    decode-side programs (`warm_decode`, `warm_spec`, `warm_swap`), zero
    the launch counts, serve the prompts, read the counts; drop the engines
    and check their memory is released.  `eager`: no CUDA graphs (the
    engine's private comparison switch); `int8`: int8 weights and KV pages,
    page INT8_PAGE; `spec_len`: speculative decoding, drafts from
    `proposer` (None: the n-gram proposer); `overload`: optimistic
    admission, {"preempt", "num_pages" (None: the default pool),
    "pressure_steps" (a `FaultPlan`'s, or None), "priorities" (one a
    prompt, or None)}, the cache's invariants held after every step (off
    the step times) and the steps that preempt two or more counted.
    Returns (outputs, phase record)."""
    import gc

    import torch
    from paddle_tpu_torch.analysis.registry import over_budget
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.inference.faults import FaultPlan
    from paddle_tpu_torch.quantization import kv_page_bytes
    page = INT8_PAGE if int8 else 16
    quant = dict(weight_dtype="int8", kv_dtype="int8") if int8 else {}
    over = dict(overload or {})
    pressure = over.pop("pressure_steps", None)
    priorities = over.pop("priorities", None) or [0] * len(prompts)
    if overload:
        quant.update(admission="optimistic", **over)

    def engine(**kw):
        return LLMEngine(params, cfg, num_slots=8, page_size=page,
                         max_model_len=2048, prefill_buckets=SERVE_BUCKETS,
                         prefill_chunk=chunk, fuse=fuse, spec_len=spec_len,
                         draft_proposer=proposer, device=dev, _eager=eager,
                         **quant, **kw)

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    warm = engine()
    warm.add_request(prompts[0][:16], max_new_tokens=2)
    warm.run()
    del warm
    eng = engine(fault_plan=FaultPlan(pressure_steps=pressure)
                 if pressure else None)
    eng.warm_decode()
    eng.warm_spec()                     # unfused spec: the verify program
    eng.warm_swap()                     # swap preemption: its two programs
    for p, prio in zip(prompts, priorities):
        eng.add_request(p, max_new_tokens=MAX_NEW, priority=prio)
    torch.cuda.synchronize()
    K.reset_launches()
    if spec_len:
        eng.proposer.reset_stats()      # the warm-up engine's calls
    steps, doubles, checks = [], [], 0.0
    t0 = time.perf_counter()
    while eng.has_work:
        pre = eng.stats()["preemptions"] if overload else 0
        s = time.perf_counter()
        eng.step()
        steps.append(time.perf_counter() - s)
        if overload:
            s = time.perf_counter()
            eng.cache.check_invariants()
            if eng.stats()["preemptions"] - pre >= 2:
                doubles.append(len(steps) - 1)
            checks += time.perf_counter() - s
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - checks
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
    # one launch a layer a program: the paged prefill kernel in the fused,
    # chunk and verify programs, the paged decode kernel in the unfused
    # decode program, the flash forward in the bucketed prefills; unfused,
    # each decode iteration is one decode or one verify dispatch (the
    # requests are greedy: no iteration takes both)
    want = {"paged_attention_kernel": L * st["decode_dispatches"],
            "paged_prefill_attention_kernel":
                L * (fused + st["chunk_dispatches"] +
                     st["verify_dispatches"])}
    if any(lane[n] != w for n, w in want.items()) or \
            launches["flash_attention_fwd"] != L * st["prefill_dispatches"] \
            or (fuse and fused == 0) or (not fuse and (
                fused or st["decode_dispatches"] + st["verify_dispatches"] !=
                st["decode_iterations"] or st["decode_iterations"] == 0)):
        raise AssertionError(f"launches {launches}, int8 {launches_int8}, "
                             f"want {want} on the pool's lane ({st})")
    if cfg.use_rms_norm and launches["rms_norm_fused"] == 0:
        raise AssertionError("RMSNorm kernel never launched")
    if chunk is None and launches["flash_attention_fwd"] == 0:
        raise AssertionError("flash kernel never launched in bucketed mode")
    # random prompts over a 128k vocabulary share no prefix: the launch
    # counts above hold only without prefix hits, but for a recompute
    # resume, which matches its own prompt's pages (whole pages: no COW)
    if st["prefix_hit_requests"] > st["preempt_recomputes"] or \
            st["cow_page_copies"]:
        raise AssertionError(f"unplanned prefix hits ({st})")
    if overload and (st["pages_in_use"] or st["swapped"] or
                     st["preemptions"] == 0):
        raise AssertionError(f"overload: {st['preemptions']} preemptions, "
                             f"{st['pages_in_use']} pages in use and "
                             f"{st['swapped']} swapped after the drain")
    # one replay a program dispatch (none when eager): the step programs
    # and the bucketed prefills; the programs within the reference's budget,
    # but for the unfused spec engine's 2 decode-side programs (decode and
    # verify), which the reference also places outside it
    replays = 0 if eager else dispatches(st)
    over = over_budget(st)
    side = 2 if spec_len and not fuse else 1
    if side == 2:
        over.pop("decode_side_executables", None)
    if st["graph_replays"] != replays or over or \
            st["decode_executables"] + st["verify_executables"] != side:
        raise AssertionError(f"graph replays {st['graph_replays']}, want "
                             f"{replays}; {side} decode-side programs "
                             f"wanted; programs over budget {over} ({st})")
    execs = {k: st[k] for k in st if k.endswith("_executables")}
    bucket_graphs = bucket_graph_count(eng)
    swap_ms = swap_replay_ms(eng) if st["swap_executables"] and not eager \
        else None
    gen = sum(len(o.token_ids) for o in outs.values())
    proposer = eng.proposer.stats() if spec_len else None
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
           "executables": execs, "bucket_graphs": bucket_graphs,
           "launches": launches, "launches_int8": launches_int8,
           "held_gib": held / 2 ** 30, "peak_mem_gib": peak / 2 ** 30,
           "left_after_release_mib": left / 2 ** 20}
    if spec_len:
        rec.update({k: st[k] for k in SPEC_KEYS}, proposer=proposer)
    rec["kv_tier"] = st["kv_tier"]
    if overload:
        rec.update({k: st[k] for k in OVERLOAD_KEYS}, num_pages=num_pages,
                   overload=overload, double_preempt_steps=doubles,
                   invariant_check_s=checks, swap_replay=swap_ms)
    return outs, rec


def swap_replay_ms(eng):
    """Device ms of one replay of the "swap_out" and "swap_in" programs on
    inert inputs (the null page at every one of the max_pages positions:
    the bytes of a full-slot swap, which every replay moves), and the ms a
    page of a pinned device-to-host copy of 64 gathered pages, the way
    `LLMEngine._swap_out` copies a victim's pages."""
    import torch
    out = {}
    for role in ("swap_out", "swap_in"):
        prog = eng._programs[role]
        for n, t in prog.inputs.items():
            if n == "ids":
                t.zero_()
        out[f"{role}_device_ms"] = device_ms(prog.graph.replay, iters=5,
                                             warmup=1)
    gathered = eng._programs["swap_out"].out
    n = min(64, eng.cache.max_pages_per_slot)
    host = {k: torch.empty((a.shape[0], n) + tuple(a.shape[2:]),
                           dtype=a.dtype, pin_memory=True)
            for k, a in gathered.items()}

    def d2h():
        for k, a in gathered.items():
            host[k].copy_(a[:, :n], non_blocking=True)
    out["d2h_ms_per_page"] = time_ms(d2h, iters=5, warmup=1) / n
    out["max_pages"] = eng.cache.max_pages_per_slot
    return out


# the overload counters of an engine's stats() that engine_overload prints
OVERLOAD_KEYS = ("admission", "preempt", "preemptions", "preempt_swaps",
                 "preempt_recomputes", "swapped_pages", "swap_ms",
                 "recomputed_tokens", "timeouts", "rejected_requests",
                 "intake_swap_rejects", "prefix_hit_requests",
                 "swap_out_dispatches", "swap_in_dispatches")


def admission_replay_ms(eng):
    """Device ms of one replay of each admission-side program on its inert
    inputs (the null page): the COW copy, the tail (chunk) program at its
    full width, each bucket's prefill.  A function of its own, so that no
    reference to a program (and through its body, the pool) outlives it."""
    out = {}
    for role, prog in eng._programs.items():
        if role in ("fused", "decode") or prog.graph is None:
            continue
        for n, t in prog.inputs.items():
            t.fill_(prog._inert[n])
        out[role] = device_ms(prog.graph.replay, iters=5, warmup=1)
    return out


def dispatches(st):
    """Every program dispatch an engine made: the step programs, the
    bucketed one-shot prefills, the COW copies and the swap gathers and
    scatters."""
    return st["fused_dispatches"] + st["decode_dispatches"] + \
        st["chunk_dispatches"] + st["verify_dispatches"] + \
        st["prefill_dispatches"] + st["cow_page_copies"] + \
        st["swap_out_dispatches"] + st["swap_in_dispatches"]


# the spec counters of an engine's stats() that engine_spec prints
SPEC_KEYS = ("spec_len", "verify_steps", "verify_dispatches", "spec_events",
             "spec_drafted_tokens", "spec_accepted_tokens",
             "spec_emitted_tokens", "accepted_per_step", "spec_backoffs")


def bucket_graph_count(eng):
    """The engine's one-shot prefill programs that run as CUDA graphs."""
    return sum(1 for role, prog in eng._programs.items()
               if role.startswith("prefill:") and prog.graph is not None)


def dequantized_params(params, cfg):
    """The int8 engine's weights dequantized for the dense `forward`: the
    table and head dequantized here, the blocks layer by layer in the
    forward (`models.gpt._w`)."""
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.quantization import quantize_serving_params
    qp = quantize_serving_params(params, cfg)
    dense = {k: v for k, v in qp.items()
             if not k.startswith(("wte_", "lm_head_"))}
    dense["wte"] = gpt._deq(qp["wte_q"], qp["wte_scale"], cfg.dtype)
    if "lm_head_q" in qp:
        dense["lm_head"] = gpt._deq(qp["lm_head_q"], qp["lm_head_scale"],
                                    cfg.dtype)
    return dense


def forward_picks(params, cfg, prompts):
    """{name: (argmax, top-2 margin)} of the dense `forward` at each
    prompt's last position."""
    import torch
    from paddle_tpu_torch.models import gpt
    picks = {}
    for name, prompt in prompts.items():
        with torch.no_grad():
            logits = gpt.forward(params, prompt[None], cfg)[0, -1]
        top2 = torch.topk(logits.float(), 2)
        picks[name] = (int(top2.indices[0]),
                       float(top2.values[0] - top2.values[1]))
    return picks


def check_first_tokens(picks, outs, what):
    """Each engine's first token against the forward's argmax, held equal
    where the top-2 margin exceeds 0.05 (ties reported)."""
    checks = []
    for name, (pick, margin) in picks.items():
        first = outs[name].token_ids[0]
        if margin > 0.05 and pick != first:
            raise AssertionError(
                f"{what} {name}: the engine's first token {first} != the "
                f"forward's argmax {pick} (margin {margin:.3g})")
        checks.append({"prompt": name, "engine": first, "forward": pick,
                       "margin": margin,
                       "result": "match" if pick == first else "tie"})
    return checks


def int8_first_tokens(params, cfg, prompts, outs):
    """The bucketed int8 engine's first tokens of prompts 0 and 1 against
    the argmax of the dense `forward` over the dequantized weights."""
    import torch
    dense = dequantized_params(params, cfg)
    checks = check_first_tokens(
        forward_picks(dense, cfg, {rid: prompts[rid] for rid in (0, 1)}),
        outs, "int8 bucketed")
    del dense
    torch.cuda.empty_cache()
    return checks


# ---------------------------------------------------------------------------
# phase 6c: the prefix cache at Llama-3-8B width
# ---------------------------------------------------------------------------

PREFIX_SYSTEM = 1000    # the shared system prompt: 62 full pages of 16 + 8
PREFIX_OWN = 24         # the donor's own tokens after it


def prefix_traffic(vocab):
    """(the donor's prompt, [(name, prompt)] of the six requests sent
    together once the donor has its first token, the 20 new tokens of the
    donor's returning session)."""
    rng = np.random.RandomState(1)

    def rand(n):
        return rng.randint(0, vocab, n).astype(np.int32)

    system, own = rand(PREFIX_SYSTEM), rand(PREFIX_OWN)
    six = [("system", system.copy()),       # ends inside the donor's page
           ("aligned", np.concatenate([system[:992], rand(50)])),
           ("cow", np.concatenate([system, own[:10], rand(40)])),
           ("tail_a", np.concatenate([system, rand(17)])),
           ("tail_b", np.concatenate([system, rand(TAIL_VALID)])),
           # a miss in the donor's bucket (1024): one bucket program
           ("unrelated", rand(int(rng.randint(600, 1001))))]
    return np.concatenate([system, own]), six, rand(20)


def want_cached(prompt, cached, page):
    """The prompt tokens a hit takes from the cache, by the page geometry:
    the common prefix with the cached sequence, at most len(prompt) - 1; a
    match ending fewer than 2 tokens into a page (the index's shortest
    partial match) stops at the page boundary."""
    n = min(len(prompt) - 1, len(cached))
    common = next((i for i in range(n) if prompt[i] != cached[i]), n)
    aligned = common // page * page
    return common if common - aligned >= 2 else aligned


def serve_prefix(params, cfg, dev, chunk=None, fuse=True, int8=False,
                 prefix_cache=True):
    """The prefix traffic through one engine (8 slots, page 16, int8 page
    INT8_PAGE, buckets SERVE_BUCKETS): the donor (system prompt + 24 own
    tokens) served to its first token, then six requests together, then,
    once the donor has finished, its returning session (prompt + 32
    generated + 20 new tokens); 32 new tokens each.  The programs the
    traffic dispatches are built first on inert inputs, as their first
    dispatch would build them, so TTFT reads serving and not capture.
    Holds each request's cached tokens to the page geometry, the hit and
    COW counts, the launches to 32 x the dispatches on the pool's lane, the
    graph replays to the dispatches, the programs to the budget, the
    drained pool to 0 pages in use and the cache's invariants.  Returns
    ({name: output}, {name: prompt}, phase record)."""
    import gc

    import torch
    from paddle_tpu_torch.analysis.registry import over_budget
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.inference.engine import LLMEngine
    page = INT8_PAGE if int8 else 16
    quant = dict(weight_dtype="int8", kv_dtype="int8") if int8 else {}
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    eng = LLMEngine(params, cfg, num_slots=8, page_size=page,
                    max_model_len=2048, prefill_buckets=SERVE_BUCKETS,
                    prefill_chunk=chunk, fuse=fuse, prefix_cache=prefix_cache,
                    device=dev, **quant)
    eng.warm_decode()
    roles = [] if chunk is not None else ["prefill:1024"] if prefix_cache \
        else ["prefill:1024", "prefill:2048"]   # without hits, 2 buckets
    if prefix_cache:
        roles += ["copy"] + (["chunk"] if chunk is None or not fuse else [])
    for role in roles:
        eng._program(role).build()
    donor, six, new = prefix_traffic(cfg.vocab_size)
    torch.cuda.synchronize()
    K.reset_launches()
    steps = []

    def step():
        s = time.perf_counter()
        eng.step()
        steps.append(time.perf_counter() - s)

    t0 = time.perf_counter()
    rid = {"donor": eng.add_request(donor, max_new_tokens=MAX_NEW)}
    while not eng.stats()["running"]:
        step()
    for name, prompt in six:
        rid[name] = eng.add_request(prompt, max_new_tokens=MAX_NEW)
    while rid["donor"] not in eng.outputs:
        step()
    gen = np.asarray(eng.outputs[rid["donor"]].token_ids, np.int32)
    back = np.concatenate([donor, gen, new])
    rid["back"] = eng.add_request(back, max_new_tokens=MAX_NEW)
    while eng.has_work:
        step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, launches_int8 = K.launches(), K.launches_int8()
    no_composed("engine_prefix")
    st = eng.stats()
    outs = {name: eng.outputs[r] for name, r in rid.items()}
    prompts = {"donor": donor, **dict(six), "back": back}
    for name, o in outs.items():
        if o.finish_reason != "length" or len(o.token_ids) != MAX_NEW or \
                not all(0 <= t < cfg.vocab_size for t in o.token_ids):
            raise AssertionError(f"engine_prefix {name}: {o.finish_reason}, "
                                 f"{len(o.token_ids)} tokens")
    # the donor registered its prompt, and at its finish the KV of its
    # prompt + generated tokens, all but the last
    conv = np.concatenate([donor, gen])[:donor.size + MAX_NEW - 1]
    want = {name: 0 if name in ("donor", "unrelated") or not prefix_cache
            else want_cached(p, conv if name == "back" else donor, page)
            for name, p in prompts.items()}
    got = {name: o.cached_tokens for name, o in outs.items()}
    hits = sum(1 for n in want.values() if n)
    cows = sum(1 for n in want.values() if n % page)
    if got != want or st["prefix_hit_requests"] != hits or \
            st["cow_page_copies"] != cows:
        raise AssertionError(f"engine_prefix: cached tokens {got}, want "
                             f"{want}; {hits} hits and {cows} COW copies "
                             f"planned ({st})")
    L = cfg.num_layers
    lane, other = (launches_int8, launches) if int8 else \
        (launches, launches_int8)
    want_l = {"paged_prefill_attention_kernel":
              L * (st["fused_dispatches"] + st["chunk_dispatches"]),
              "paged_attention_kernel": L * st["decode_dispatches"]}
    if any(lane[n] != w for n, w in want_l.items()) or \
            any(other[n] for n in want_l) or \
            launches["flash_attention_fwd"] != L * st["prefill_dispatches"]:
        raise AssertionError(f"engine_prefix launches {launches}, int8 "
                             f"{launches_int8}, want {want_l} ({st})")
    over = over_budget(st)
    if st["graph_replays"] != dispatches(st) or over or \
            st["decode_executables"] != 1 or \
            st["copy_executables"] != int(prefix_cache):
        raise AssertionError(f"engine_prefix: graph replays "
                             f"{st['graph_replays']}, programs over budget "
                             f"{over} ({st})")
    if st["pages_in_use"]:
        raise AssertionError(f"engine_prefix: {st['pages_in_use']} pages "
                             f"in use after the drain")
    eng.cache.check_invariants()
    execs = {k: st[k] for k in st if k.endswith("_executables")}
    peak = torch.cuda.max_memory_allocated(dev)
    gen_tokens = sum(len(o.token_ids) for o in outs.values())
    replay_ms = admission_replay_ms(eng)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(dev) - held
    if left > RELEASE_SLACK:
        raise AssertionError(f"the dropped engine left {left / 2**20:.1f} "
                             f"MiB allocated")
    rec = {"prefix_cache": prefix_cache, "page_size": page,
           "prefill_chunk": chunk, "fuse": fuse,
           "weight_dtype": st["weight_dtype"], "kv_dtype": st["kv_dtype"],
           "prompt_lens": {n: int(p.size) for n, p in prompts.items()},
           "cached_tokens": got,
           "ttft_ms": {n: 1e3 * o.ttft_s for n, o in outs.items()},
           **{k: st[k] for k in (
               "prefilled_tokens", "prefix_cached_tokens",
               "prefix_hit_requests", "prefix_hit_rate", "cow_page_copies",
               "prefix_evictions", "pages_evictable", "prefill_chunks",
               "fused_dispatches", "decode_dispatches", "chunk_dispatches",
               "prefill_dispatches", "graph_replays")},
           "generated_tokens": gen_tokens, "wall_s": wall,
           "tokens_per_s": gen_tokens / wall, "engine_steps": len(steps),
           "mean_step_ms": 1e3 * wall / len(steps),
           "median_step_ms": 1e3 * float(np.median(steps)),
           "executables": execs, "replay_device_ms": replay_ms,
           "launches": launches, "launches_int8": launches_int8,
           "peak_mem_gib": peak / 2 ** 30,
           "left_after_release_mib": left / 2 ** 20}
    return outs, prompts, rec


def agreement(a, b):
    """Greedy agreement of two runs' outputs {rid: RequestOutput}."""
    same = [a[r].token_ids == b[r].token_ids for r in a]
    tok = [x == y for r in a for x, y in zip(a[r].token_ids, b[r].token_ids)]
    return {"identical_streams": sum(same),
            "first_tokens_identical": sum(a[r].token_ids[0] ==
                                          b[r].token_ids[0] for r in a),
            "of": len(same), "token_rate": sum(tok) / len(tok)}


# ---------------------------------------------------------------------------
# phase 6d: speculative decoding at Llama-3-8B width
# ---------------------------------------------------------------------------

def spec_traffic(vocab):
    """Prompts that repeat, as code and structured text do: a seeded random
    SPEC_PATTERN-token pattern for each request, tiled to PROMPT_LENS
    (`step_profile.py --spec-len` keeps a copy: change them together)."""
    rng = np.random.RandomState(3)
    return [np.resize(rng.randint(0, vocab, SPEC_PATTERN).astype(np.int32),
                      n) for n in PROMPT_LENS]


def lossless(params, cfg, prompts, outs, what, rids=(0, 1), required=True):
    """Each generated token of requests `rids` against the argmax of one
    dense `forward` over prompt + generated at the position before it (the
    logits of its last hidden states taken in float32, so the margin is
    not one of the logits' own bf16 steps).  Positions where they differ
    are listed with the top-2 margin; `required`: raise if one of them has
    a margin above 0.05."""
    import torch
    from paddle_tpu_torch.models import gpt
    checks = []
    for rid in rids:
        prompt, gen = prompts[rid], outs[rid].token_ids
        seq = np.concatenate([prompt, np.asarray(gen[:-1], np.int32)])
        with torch.no_grad():
            x, head, _ = gpt.backbone(params, seq[None], cfg)
            logits = x[0, prompt.size - 1:].float() @ head.float()
        top2 = torch.topk(logits, 2)
        picks = top2.indices[:, 0].tolist()
        margins = (top2.values[:, 0] - top2.values[:, 1]).tolist()
        del x, head, logits
        off = [{"position": t, "engine": tok, "forward": pick,
                "margin": margin}
               for t, (tok, pick, margin) in enumerate(zip(gen, picks,
                                                           margins))
               if tok != pick]
        checks.append({"request": rid, "tokens": len(gen),
                       "min_margin": min(margins), "differ": off,
                       "max_differ_margin": max((d["margin"] for d in off),
                                                default=None)})
        if required and any(d["margin"] > 0.05 for d in off):
            raise AssertionError(f"{what} request {rid}: the engine's tokens "
                                 f"differ from the forward's argmax above "
                                 f"the 0.05 margin: {off}")
    return checks


def engine_spec(params, cfg, dev):
    """Phase 6d (see the module docstring): ({mode: phase record}, {spec-off
    baseline: its `lossless` record}).  Spec off first (the baselines,
    whose streams the replay modes draft), then the n-gram proposer on the
    same traffic, then the modes with replayed drafts."""
    import torch
    from paddle_tpu_torch.inference.step_profile import ReplayProposer
    prompts_s = spec_traffic(cfg.vocab_size)
    # float32 (the bf16 weights, computed in f32): rounding far below the
    # random model's top-2 margins, where lossless is a strict check
    params32, cfg32 = f32_weights(params, cfg)
    weights = {"bf16": (params, cfg, False), "int8": (params, cfg, True),
               "f32": (params32, cfg32, False)}
    sent = {w: prompts_s[:SPEC_INT8_REQUESTS] if w == "int8" else prompts_s
            for w in weights}
    spec_off, rec_s, lossless_off = {}, {}, {}
    for key, w, chunk in (("bf16", "bf16", None), ("bf16_chunked", "bf16", 16),
                          ("int8", "int8", None), ("f32", "f32", None)):
        p_, c_, int8 = weights[w]
        spec_off[key], rec = serve(p_, c_, sent[w], chunk, dev, int8=int8)
        rec_s[f"spec_off_{key}"] = rec
        if chunk is None:
            lossless_off[key] = lossless(
                dequantized_params(params, cfg) if int8 else p_, c_,
                sent[w], spec_off[key], f"spec_off_{key}", required=False)
    outs, rec = serve(params, cfg, sent["bf16"], None, dev,
                      spec_len=SPEC_LEN)
    rec["agreement_with_spec_off"] = agreement(spec_off["bf16"], outs)
    rec_s["ngram_bucketed"] = rec
    for mode, chunk, fuse, w, base in (
            ("bucketed", None, True, "bf16", "bf16"),
            ("chunked", 16, True, "bf16", "bf16_chunked"),
            ("unfused_bucketed", None, False, "bf16", "bf16"),
            ("int8_bucketed", None, True, "int8", "int8"),
            ("f32_bucketed", None, True, "f32", "f32"),
            ("f32_unfused_bucketed", None, False, "f32", "f32")):
        p_, c_, int8 = weights[w]
        replay = ReplayProposer([(p, spec_off[base][r].token_ids)
                                 for r, p in enumerate(sent[w])])
        outs, rec = serve(p_, c_, sent[w], chunk, dev, fuse=fuse, int8=int8,
                          spec_len=SPEC_LEN, proposer=replay)
        if rec["spec_events"] == 0:
            raise AssertionError(f"engine_spec {mode}: no draft was "
                                 f"verified ({rec})")
        # requests 0 and 1 against the dense forward (over the dequantized
        # weights for int8): required in f32; in bf16 and int8 reported
        # beside the spec-off engine's own record on the same traffic (the
        # bf16 engine's rounding already exceeds the 0.05 margin there)
        ref_params = dequantized_params(params, cfg) if int8 else p_
        rec["lossless"] = lossless(ref_params, c_, sent[w], outs, mode,
                                   required=w == "f32")
        del ref_params
        torch.cuda.empty_cache()
        rec["agreement_with_spec_off"] = agreement(spec_off[base], outs)
        rec_s[mode] = rec
    return rec_s, lossless_off


# ---------------------------------------------------------------------------
# phase 6e: optimistic admission and preemption at Llama-3-8B width
# ---------------------------------------------------------------------------

# (a) fused chunked, recompute: steps of the PROMPT_LENS schedule at chunk
# 16 where two or three slots decode while a prompt is mid-chunk
OVERLOAD_PRESSURE = (12, 25, 45, 62)
# (b), (c) bucketed swap: 212 real pages.  The prompts take 204, so all 8
# are admitted and prefilled in the first step; its decode takes the last 8
# pages, and 16 steps later every slot needs a page again.  Request 0 (5
# pages, the lowest priority) is the first victim and frees too few, so
# request 1 is the second of the same growth pass (at one priority the
# victim with more pages goes first, and request 1's 7 would do alone)
OVERLOAD_PAGES = 213
OVERLOAD_PRIORITIES = (-2, -1, 0, 0, 0, 0, 0, 0)
# (d) int8 at page 32, and (e) float32 at page 16, OVERLOAD_REQUESTS
# requests: their prompts take 18 (d) and 36 (e) pages and grow once (d),
# at L and at L + 16 (e); a pool of 20 (d) and 40 (e) real pages fails one
# growth, and the victim waits for pages until the others finish
OVERLOAD_REQUESTS = 4
OVERLOAD_INT8_PAGES = 21
OVERLOAD_F32_PAGES = 41


def f32_weights(params, cfg):
    """The bf16 weights computed in float32 (engine_spec's and
    engine_overload's f32 runs): (params, cfg)."""
    import torch
    from paddle_tpu_torch.models import gpt
    cfg32 = gpt.GPTConfig(**{**cfg.__dict__, "dtype": torch.float32})
    params32 = {k: ({n: w.float() for n, w in v.items()}
                    if isinstance(v, dict) else v.float())
                for k, v in params.items()}
    return params32, cfg32


def first_divergences(params, cfg, prompts, base, outs):
    """For each request whose stream leaves `base`'s: the first position
    that differs, both tokens, and the dense `forward`'s argmax and top-2
    margin there (its last hidden state's logits in float32), over the
    prompt and the tokens both streams share."""
    import torch
    from paddle_tpu_torch.models import gpt
    found = []
    for rid, out in outs.items():
        a, b = base[rid].token_ids, out.token_ids
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        seq = np.concatenate([prompts[rid], np.asarray(a[:i], np.int32)])
        with torch.no_grad():
            x, head, _ = gpt.backbone(params, seq[None], cfg)
            top2 = torch.topk(x[0, -1].float() @ head.float(), 2)
        found.append({"request": rid, "position": i, "undisturbed": a[i],
                      "engine": b[i], "forward": int(top2.indices[0]),
                      "margin": float(top2.values[0] - top2.values[1])})
        del x, head
    return found


def engine_overload(params, cfg, prompts, dev, base):
    """Phase 6e (see the module docstring): {mode: phase record}.  `base`:
    {name: (outputs, record)} of the undisturbed runs of phases 3, 4, 5 and
    6b that the modes are held against."""
    import torch
    few = prompts[:OVERLOAD_REQUESTS]
    swap = dict(preempt="swap", num_pages=OVERLOAD_PAGES,
                priorities=OVERLOAD_PRIORITIES)
    rec = {}
    for mode, sent, chunk, fuse, int8, over, name in (
            ("a_chunked_recompute", prompts, 16, True, False,
             dict(preempt="recompute", num_pages=None,
                  pressure_steps=OVERLOAD_PRESSURE), "chunked"),
            ("b_bucketed_swap", prompts, None, True, False, swap, "bucketed"),
            ("c_unfused_swap", prompts, None, False, False, swap, "unfused"),
            ("d_int8_swap", few, None, True, True,
             dict(preempt="swap", num_pages=OVERLOAD_INT8_PAGES), "int8")):
        outs, r = serve(params, cfg, sent, chunk, dev, fuse=fuse, int8=int8,
                        overload=over)
        ref_outs, ref_rec = base[name]
        agree = agreement({rid: ref_outs[rid] for rid in outs}, outs)
        r.update(undisturbed=name, agreement_with_undisturbed=agree,
                 undisturbed_tokens_per_s=ref_rec["tokens_per_s"],
                 undisturbed_median_step_ms=ref_rec["median_step_ms"])
        if over["preempt"] == "recompute":
            # bf16: a recomputed position's KV comes from a prefill lane,
            # the undisturbed one's from the decode step, and the two round
            # differently; where a stream leaves, the forward's margin
            r["first_divergences"] = first_divergences(
                params, cfg, sent, ref_outs, outs)
            torch.cuda.empty_cache()
        if over["preempt"] == "swap":
            # a swap restores the exact bytes into the same fixed-shape
            # programs: the stream is the undisturbed one, bitwise
            if r["preempt_swaps"] == 0 or \
                    r["executables"]["swap_executables"] != 2 or \
                    agree["identical_streams"] != agree["of"]:
                raise AssertionError(f"engine_overload {mode}: swaps "
                                     f"{r['preempt_swaps']}, programs "
                                     f"{r['executables']}, agreement {agree}")
        rec[mode] = r
    if not (rec["b_bucketed_swap"]["double_preempt_steps"] or
            rec["c_unfused_swap"]["double_preempt_steps"]):
        raise AssertionError("engine_overload: no step preempted two victims")
    # (e) float32, where a recompute's prefill rounds far below the random
    # model's margins: held equal to the reservation run of its requests
    params32, cfg32 = f32_weights(params, cfg)
    base32, rec["e_f32_reservation"] = serve(params32, cfg32, few, None, dev)
    outs, r = serve(params32, cfg32, few, None, dev,
                    overload=dict(preempt="recompute",
                                  num_pages=OVERLOAD_F32_PAGES))
    del params32
    torch.cuda.empty_cache()
    agree = agreement(base32, outs)
    r.update(undisturbed="e_f32_reservation",
             agreement_with_undisturbed=agree,
             undisturbed_tokens_per_s=rec["e_f32_reservation"][
                 "tokens_per_s"],
             undisturbed_median_step_ms=rec["e_f32_reservation"][
                 "median_step_ms"])
    if agree["identical_streams"] != agree["of"]:
        raise AssertionError(f"engine_overload e_f32_recompute: streams "
                             f"differ from the reservation run's {agree}")
    rec["e_f32_recompute"] = r
    return rec


# ---------------------------------------------------------------------------
# phase 6f: KV tiering, the durable store and roles at Llama-3-8B width
# ---------------------------------------------------------------------------

# page 16: wave 1 takes 220 pages at prompt + 32, wave 3 268 at prompt + 128
# (its longest 1152 tokens), so 280 real pages hold one wave at a time.  The
# host pool holds what the never-evicting pool holds (1024 pages, 2 GiB):
# at the device pool's 280 (the default) the flush and the returning wave's
# own evictions push the oldest spilled sessions out before they return
TIER_PAGES = 281
TIER_BASE_PAGES = 1025      # never evicts: waves 1 and 3 together, 2 GiB
TIER_FRESH = 64             # a returning turn's new tokens
# int8 at page 32, TIER_INT8_REQUESTS sessions: wave 1 takes 22 pages, wave
# 3 34, and 36 real pages hold one wave at a time
TIER_INT8_REQUESTS = SPEC_INT8_REQUESTS
TIER_INT8_PAGES = 37
TIER_INT8_BASE_PAGES = 129
TIER_KEYS = ("spills", "restores", "restored_tokens", "partial_page_hits",
             "disk_spills", "disk_restores", "tier_drops", "pages_host",
             "pages_disk", "handoff_exports", "handoff_pages",
             "handoff_tokens", "store_nodes_restored")


def tier_waves(vocab, prompts):
    """Wave 2: fresh seeded prompts of the wave-1 lengths.  Returns
    (wave 2, fn(wave-1 replies) -> wave 3: each wave-1 prompt + its reply
    + TIER_FRESH fresh seeded tokens)."""
    rng = np.random.RandomState(15)
    flush = [rng.randint(0, vocab, p.size).astype(np.int32) for p in prompts]
    fresh = [rng.randint(0, vocab, TIER_FRESH).astype(np.int32)
             for _ in prompts]

    def returning(replies):
        return [np.concatenate([p, np.asarray(r, np.int32), f])
                for p, r, f in zip(prompts, replies, fresh)]
    return flush, returning


def tier_engine(params, cfg, dev, chunk, int8=False, **kw):
    """An engine of the phase (8 slots, page 16 or INT8_PAGE, buckets
    SERVE_BUCKETS), its decode-side and swap programs built."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    quant = dict(weight_dtype="int8", kv_dtype="int8") if int8 else {}
    eng = LLMEngine(params, cfg, num_slots=8,
                    page_size=INT8_PAGE if int8 else 16, max_model_len=2048,
                    prefill_buckets=SERVE_BUCKETS, prefill_chunk=chunk,
                    device=dev, **quant, **kw)
    eng.warm_decode()
    eng.warm_swap()
    return eng


def tier_wave(eng, prompts, vocab):
    """Serve one wave to completion: the cache's invariants after every
    step (off the step times).  Returns ([output] in order, wall s, [step
    s], invariant-check s)."""
    import torch
    rids = [eng.add_request(p, max_new_tokens=MAX_NEW) for p in prompts]
    steps, checks = [], 0.0
    t0 = time.perf_counter()
    while eng.has_work:
        s = time.perf_counter()
        eng.step()
        steps.append(time.perf_counter() - s)
        s = time.perf_counter()
        eng.cache.check_invariants()
        checks += time.perf_counter() - s
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - checks
    outs = [eng.outputs[r] for r in rids]
    for r, o in zip(rids, outs):
        if o.finish_reason != "length" or len(o.token_ids) != MAX_NEW or \
                not all(0 <= t < vocab for t in o.token_ids):
            raise AssertionError(f"engine_tier request {r}: "
                                 f"{o.finish_reason}, {len(o.token_ids)} "
                                 f"tokens")
    return outs, wall, steps, checks


def tier_launch_check(st, launches, launches_int8, L, int8, budget=True):
    """Launches 32 x the dispatches on the pool's lane, none on the other,
    no composed call, graph replays = dispatches, programs within the
    budget (unless `budget` is False), at most 2 swap programs, one
    "swap_in" replay a restore."""
    from paddle_tpu_torch.analysis.registry import over_budget
    no_composed("engine_tier")
    lane, other = (launches_int8, launches) if int8 else \
        (launches, launches_int8)
    paged = "paged_prefill_attention_kernel"
    want = L * (st["fused_dispatches"] + st["chunk_dispatches"])
    tier = st["kv_tier"]
    if lane[paged] != want or other[paged] or \
            launches["flash_attention_fwd"] != L * st["prefill_dispatches"] \
            or launches["rms_norm_fused"] == 0 or \
            st["graph_replays"] != dispatches(st) or \
            (budget and over_budget(st)) or \
            st["swap_executables"] > 2 or \
            st["swap_in_dispatches"] != tier["restores"] + \
            st["preempt_swaps"]:
        raise AssertionError(f"engine_tier: launches {launches}, int8 "
                             f"{launches_int8}, paged want {want}; programs "
                             f"over budget {over_budget(st)} ({st})")


def tier_run(params, cfg, dev, prompts, chunk, int8=False, waves=(1, 2, 3),
             role_dirs=None, budget=True, **kw):
    """One run of the phase: waves 1, 2 (the flush) and 3 (the returning
    turns), or the subset `waves`, through one engine; with `role_dirs`
    (the store directory), wave 1 on a role="prefill" engine that exports
    each conversation and is dropped, wave 3 on a role="decode" engine on
    the same directory.  Launch counts zeroed just before the waves and
    read just after; `budget`: hold the programs to the budget.  Returns
    ({wave: [output]}, run record)."""
    import gc

    import torch
    from paddle_tpu_torch.incubate import kernels as K
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    flush, returning = tier_waves(cfg.vocab_size, prompts)
    roles = role_dirs is not None
    eng = tier_engine(params, cfg, dev, chunk, int8,
                      **(dict(role="prefill", spill_dir=role_dirs)
                         if roles else {}), **kw)
    outs, rec, exports = {}, {"waves": {}}, []
    # launches of the run, and of the engine serving now (each engine's
    # are held to its own dispatches)
    launches, launches_int8, mine = {}, {}, ({}, {})

    def count():
        for got, ds in ((K.launches(), (launches, mine[0])),
                        (K.launches_int8(), (launches_int8, mine[1]))):
            for d in ds:
                for n, v in got.items():
                    d[n] = d.get(n, 0) + v

    def serve(wave, sent):
        torch.cuda.synchronize()
        K.reset_launches()
        o, wall, steps, checks = tier_wave(eng, sent, cfg.vocab_size)
        count()
        outs[wave] = o
        gen = sum(len(x.token_ids) for x in o)
        ttft = [1e3 * x.ttft_s for x in o]
        # the first step admits the whole wave: its spills, restores and
        # store reads, and the one-shot prefills in bucketed mode
        rec["waves"][wave] = {
            "wall_s": wall, "engine_steps": len(steps),
            "first_step_ms": 1e3 * steps[0],
            "median_step_ms": 1e3 * float(np.median(steps)),
            "invariant_check_s": checks, "tokens_per_s": gen / wall,
            "ttft_ms": ttft, "ttft_median_ms": float(np.median(ttft)),
            "ttft_max_ms": max(ttft),
            "cached_tokens": [x.cached_tokens for x in o]}

    stats = []
    for wave in waves:
        if wave == 3 and roles:
            for p, o in zip(prompts, outs[1]):
                exports.append(eng.export_prefix(
                    np.concatenate([p, np.asarray(o.token_ids, np.int32)])))
            eng.cache.check_invariants()
            st = eng.stats()
            tier_launch_check(st, *mine, cfg.num_layers, int8)
            stats.append(st)
            mine = ({}, {})
            del eng
            gc.collect()
            eng = tier_engine(params, cfg, dev, chunk, int8, role="decode",
                              spill_dir=role_dirs, **kw)
            rec["decode_store_nodes_restored_at_init"] = \
                eng.stats()["kv_tier"]["store_nodes_restored"]
        before = eng.stats()
        sent = prompts if wave == 1 else flush if wave == 2 else \
            returning([o.token_ids for o in outs[1]])
        serve(wave, sent)
        after = eng.stats()
        rec["waves"][wave]["prefilled_tokens"] = \
            after["prefilled_tokens"] - before["prefilled_tokens"]
        rec["waves"][wave]["restores"] = \
            after["kv_tier"]["restores"] - before["kv_tier"]["restores"]
    st = eng.stats()
    tier_launch_check(st, *mine, cfg.num_layers, int8, budget)
    stats.append(st)
    if st["pages_in_use"] or \
            st["kv_tier"]["pages_host"] > eng.swap_pool_pages:
        raise AssertionError(f"engine_tier: {st['pages_in_use']} pages in "
                             f"use after the drain, "
                             f"{st['kv_tier']['pages_host']} host tier "
                             f"pages over {eng.swap_pool_pages}")
    tier = {k: sum(s["kv_tier"][k] for s in stats) for k in TIER_KEYS}
    restores = tier["restores"]
    swap = swap_replay_ms(eng) if st["swap_executables"] == 2 else None
    rec.update(
        kv_tier_enabled=st["kv_tier"]["enabled"], num_pages=
        eng.cache.num_pages, swap_pool_pages=eng.swap_pool_pages,
        page_size=eng.cache.page_size, prefill_chunk=chunk,
        kv_dtype=st["kv_dtype"], role_handoff=roles, kv_tier=tier,
        exports=exports,
        swap_in_inputs=sorted(eng._programs["swap_in"].inputs)
        if "swap_in" in eng._programs else None,
        restore_stage_ms=sum(s["tier_stage_ms"] for s in stats) / restores
        if restores else None,
        swap_replay=swap, swap_ms=sum(s["swap_ms"] for s in stats),
        executables={k: st[k] for k in st if k.endswith("_executables")},
        launches=launches, launches_int8=launches_int8)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated(dev) - held
    if left > RELEASE_SLACK:
        raise AssertionError(f"engine_tier: the dropped engines left "
                             f"{left / 2**20:.1f} MiB allocated")
    return outs, rec


def npz_page_ms(cfg, page=16, n=8):
    """ms a page of the store level: `LocalDirStore.put` and `get` of n
    bf16 page slabs [L, page, KVH, hd] of k and v (as the tier writes
    them, raw 2-byte lanes), in a temporary directory."""
    import shutil
    import tempfile

    import torch
    from paddle_tpu_torch.inference.cache import (LocalDirStore,
                                                  lane_to_numpy)
    shape = (cfg.num_layers, page, cfg.kv_heads, cfg.head_dim)
    slab = {k: lane_to_numpy(torch.randn(shape, dtype=torch.bfloat16))
            for k in ("k", "v")}
    root = tempfile.mkdtemp()
    try:
        store = LocalDirStore(root)
        t0 = time.perf_counter()
        for i in range(n):
            store.put(f"kvnode_x_{i}", slab)
        put = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i in range(n):
            store.get(f"kvnode_x_{i}")
        get = time.perf_counter() - t0
    finally:
        shutil.rmtree(root)
    return {"write_ms_per_page": 1e3 * put / n,
            "read_ms_per_page": 1e3 * get / n,
            "page_bytes": sum(a.nbytes for a in slab.values())}


def engine_tier(params, cfg, dev, prompts, smi):
    """Phase 6f (see the module docstring): {mode: record}."""
    import os
    import shutil
    import tempfile
    few = prompts[:TIER_INT8_REQUESTS]
    rec = {}

    def held_to(mode, outs, base, what):
        # wave 3 restored: the same bytes into the same programs at the
        # same matched tokens as the baseline's device hits
        for w in (1, 3):
            if outs.get(w) is None:
                continue
            got = [o.token_ids for o in outs[w]]
            want = [o.token_ids for o in base[w]]
            cached = [o.cached_tokens for o in outs[w]]
            bcached = [o.cached_tokens for o in base[w]]
            if got != want or cached != bcached:
                raise AssertionError(
                    f"engine_tier {mode} wave {w}: streams or cached tokens "
                    f"differ from {what} ({cached} against {bcached})")

    # (a) fused chunked, host tier; a never-evicting baseline; re-prefill
    outs, r = tier_run(params, cfg, dev, prompts, 16, num_pages=TIER_PAGES,
                       swap_pool_pages=TIER_BASE_PAGES - 1)
    base, rb = tier_run(params, cfg, dev, prompts, 16, waves=(1, 3),
                        num_pages=TIER_BASE_PAGES)
    held_to("a", outs, base, "the never-evicting pool")
    re_outs, rr = tier_run(params, cfg, dev, prompts, 16, kv_tier=False,
                           num_pages=TIER_PAGES,
                           swap_pool_pages=TIER_BASE_PAGES - 1)
    t = r["kv_tier"]
    if not (t["spills"] > 0 and t["restores"] > 0) or \
            rb["kv_tier"]["spills"] or rr["kv_tier"]["restores"]:
        raise AssertionError(f"engine_tier a: tier {t}, baseline "
                             f"{rb['kv_tier']}, re-prefill {rr['kv_tier']}")
    r["wave3_agreement_reprefill"] = agreement(
        dict(enumerate(outs[3])), dict(enumerate(re_outs[3])))
    rec["a_chunked_host"] = {"tier": r, "baseline": rb, "reprefill": rr}

    # (b) fused bucketed: a prefill-role engine exports wave 1 to a store
    # directory, a decode-role engine on it serves wave 3 from the disk
    root = tempfile.mkdtemp()
    try:
        outs, r = tier_run(params, cfg, dev, prompts, None, waves=(1, 3),
                           role_dirs=root, num_pages=TIER_PAGES)
        r["store_files"] = len(os.listdir(root))
    finally:
        shutil.rmtree(root)
    # the baseline alone serves both waves: wave 1's misses in buckets 512
    # and 1024 and wave 3's hit tails through the chunk program, 3 prefill
    # programs against the budget's 2 (the prefill and decode engines of
    # the tier run take 2 and 1); its programs are reported
    base, rb = tier_run(params, cfg, dev, prompts, None, waves=(1, 3),
                        num_pages=TIER_BASE_PAGES, budget=False)
    held_to("b", outs, base, "the never-evicting bucketed pool")
    t = r["kv_tier"]
    if t["handoff_exports"] != len(prompts) or t["disk_restores"] == 0 or \
            r["decode_store_nodes_restored_at_init"] == 0:
        raise AssertionError(f"engine_tier b: {t}")
    rec["b_bucketed_roles_disk"] = {"tier": r, "baseline": rb}

    # (c) int8 weights and KV at page 32, fused chunked, host tier
    outs, r = tier_run(params, cfg, dev, few, 16, int8=True,
                       num_pages=TIER_INT8_PAGES,
                       swap_pool_pages=TIER_INT8_BASE_PAGES - 1)
    base, rb = tier_run(params, cfg, dev, few, 16, int8=True, waves=(1, 3),
                        num_pages=TIER_INT8_BASE_PAGES)
    held_to("c", outs, base, "the never-evicting int8 pool")
    t = r["kv_tier"]
    if not (t["spills"] > 0 and t["restores"] > 0) or \
            r["swap_in_inputs"] != ["ids", "k", "k_scale", "v", "v_scale"]:
        raise AssertionError(f"engine_tier c: {t}, swap_in inputs "
                             f"{r['swap_in_inputs']}")
    rec["c_int8_chunked_host"] = {"tier": r, "baseline": rb}
    rec["npz"] = npz_page_ms(cfg)
    rec["nvidia_smi"] = smi
    return rec


# ---------------------------------------------------------------------------
# phase 6g: metrics, tracing and health at Llama-3-8B width
# ---------------------------------------------------------------------------

OBS_SPANS = ("engine.step", "engine.admit", "engine.prefill.dispatch",
             "engine.fused.dispatch", "engine.sample.sync")
# the kernels a traced bucketed pass must name (rows 1, 2 and 3)
OBS_KERNELS = ("paged_prefill_kernel", "flash_fwd_wgmma", "rms_")
# the 2-layer engine's forced pool pressure: engine steps after its reset
OBS_PRESSURE = (3, 4, 5, 6, 7, 8)
PROM_SAMPLE = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? '
                         r'(\S+)( # \{.*\} \S+)?$')


def prometheus_samples(text):
    """The samples of a Prometheus text exposition, each line parsed (HELP
    and TYPE comments, `name{labels} value`, an OpenMetrics exemplar);
    raises on a line that is neither."""
    n = 0
    for line in text.splitlines():
        if not line or line.startswith(("# HELP ", "# TYPE ")) or \
                line == "# EOF":
            continue
        m = PROM_SAMPLE.match(line)
        if m is None:
            raise AssertionError(f"engine_obs: bad exposition line {line!r}")
        float(m.group(2))
        n += 1
    return n


def obs_engine(params, cfg, dev, **kw):
    """Phase 3's engine (fused bucketed, `request_tracing` at its default
    unless given)."""
    from paddle_tpu_torch.inference.engine import LLMEngine
    return LLMEngine(params, cfg, num_slots=8, page_size=16,
                     max_model_len=2048, prefill_buckets=SERVE_BUCKETS,
                     device=dev, **kw)


def obs_pass(eng, prompts):
    """Zero the engine's counters, serve `prompts` x MAX_NEW to the end.
    Returns (outputs in request order, each step's wall seconds, the
    steady steps' host seconds: the step less its wait for the device
    result, from the step ring; the steady steps are those after the
    admitting one that dispatched the full decode batch)."""
    import torch
    eng.reset_counters()
    rids = [eng.add_request(p, max_new_tokens=MAX_NEW) for p in prompts]
    walls = []
    while eng.has_work:
        s = time.perf_counter()
        eng.step()
        walls.append(time.perf_counter() - s)
    torch.cuda.synchronize()
    ring = eng.step_trace()
    if len(ring) != len(walls):
        raise AssertionError(f"engine_obs: {len(ring)} step records for "
                             f"{len(walls)} steps")
    steady = [i for i, r in enumerate(ring) if i > 0 and
              r["dispatches"] == 1 and r["decode_batch"] == len(prompts)]
    host = [ring[i]["dur_s"] - ring[i]["sync_ms"] / 1e3 for i in steady]
    return [eng._outputs[r] for r in rids], [walls[i] for i in steady], host


def obs_times(walls, host):
    return {"steps": len(walls),
            "median_ms": 1e3 * float(np.median(walls)),
            "mean_ms": 1e3 * float(np.mean(walls)),
            "host_median_ms": 1e3 * float(np.median(host)),
            "host_mean_ms": 1e3 * float(np.mean(host))}


def device_kernels(path):
    """(kernel event count, their names) of a torch.profiler chrome
    trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return len(names), names


def engine_obs(params, cfg, prompts, dev, smi):
    """Phase 6g (see the module docstring): (the traced pass's outputs,
    {prompt index: output}; the phase's record, with the traced pass's
    launch counts)."""
    import dataclasses
    import gc
    import os
    import shutil
    import tempfile
    import weakref

    import torch
    from paddle_tpu_torch.analysis.registry import over_budget
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.inference.faults import FaultPlan
    from paddle_tpu_torch.inference.health import HEALTH_CODES
    rng = np.random.RandomState(16)

    def fresh():
        return [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
                for n in PROMPT_LENS]

    def released(what):
        gc.collect()
        torch.cuda.empty_cache()
        left = torch.cuda.memory_allocated(dev) - held
        if left > RELEASE_SLACK:
            raise AssertionError(f"engine_obs: {what} left "
                                 f"{left / 2**20:.1f} MiB allocated")
        return left / 2 ** 20

    warm_prompts, over1, over2 = fresh(), fresh(), fresh()
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    rec = {"nvidia_smi": smi}
    root = tempfile.mkdtemp()
    try:
        # (1) warm every program on a first pass, off the window
        traced = obs_engine(params, cfg, dev)
        if not traced._req_tracing:
            raise AssertionError("engine_obs: request tracing is off by "
                                 "default")
        traced.warm_decode()
        traced.warm_swap()              # the KV tier's spills and restores
        obs_pass(traced, warm_prompts)
        built = sorted(r for r, p in traced._programs.items() if p.built)
        # (2) the traced pass
        tdir = os.path.join(root, "trace")
        torch.cuda.synchronize()
        K.reset_launches()
        t0 = time.perf_counter()
        with traced.trace(tdir, device=True) as prof:
            outs, walls, host = obs_pass(traced, prompts)
        window_s = time.perf_counter() - t0
        launches, launches_int8 = K.launches(), K.launches_int8()
        no_composed("engine_obs")
        st = traced.stats()
        now_built = sorted(r for r, p in traced._programs.items()
                           if p.built)
        if now_built != built:
            raise AssertionError(f"engine_obs: programs {now_built} built, "
                                 f"{built} before the window")
        with open(os.path.join(tdir, "host_trace.json")) as f:
            spans = {e["name"] for e in json.load(f)["traceEvents"]}
        if not set(OBS_SPANS) <= spans:
            raise AssertionError(f"engine_obs: host spans {sorted(spans)}")
        with open(os.path.join(tdir, "step_timeline.json")) as f:
            timeline = json.load(f)
        if len(timeline) != st["engine_steps"] or \
                any(r["v"] != 2 or r["dispatches"] > 1 for r in timeline):
            raise AssertionError(f"engine_obs: step timeline of "
                                 f"{len(timeline)} records for "
                                 f"{st['engine_steps']} steps")
        with open(os.path.join(tdir, "metrics.json")) as f:
            snap = json.load(f)
        if snap["counters"]["decode_tokens"] != st["decode_tokens"]:
            raise AssertionError("engine_obs: metrics.json disagrees with "
                                 "stats()")
        samples = prometheus_samples(traced.metrics.to_prometheus())
        prometheus_samples(traced.metrics.to_prometheus(openmetrics=True))
        n_kernels, names = device_kernels(prof.device_trace_path)
        named = {k: sum(k in n for n in names) for k in OBS_KERNELS}
        rec["device_trace"] = {"kernel_events": n_kernels,
                               "named_on_graphs": named,
                               "distinct_kernels": len(set(names))}
        if n_kernels == 0:
            raise AssertionError("engine_obs: no CUDA kernel in the device "
                                 "trace")
        lat = st["latency"]
        if lat["ttft_s"]["count"] != len(prompts) or \
                lat["e2e_s"]["count"] != len(prompts):
            raise AssertionError(f"engine_obs: latency {lat}")
        for o in outs:
            m = o.metrics
            ev = [e["name"] for e in o.trace.events]
            if not (m.queue_s <= m.ttft_s <= m.e2e_s) or \
                    m.n_generated != MAX_NEW or ev[0] != "enqueue" or \
                    "first_token" not in ev or ev[-1] != "finish":
                raise AssertionError(f"engine_obs: request "
                                     f"{o.request_id}: {m}, {ev}")
        over = over_budget(st)
        if st["roofline"]["steady_state_recompiles"] or over or \
                st["health"]["state"] in ("error", "overloaded"):
            raise AssertionError(f"engine_obs: recompiles "
                                 f"{st['roofline']}, over budget {over}, "
                                 f"health {st['health']}")
        L = cfg.num_layers
        if launches["paged_prefill_attention_kernel"] != \
                L * st["fused_dispatches"] or \
                launches["flash_attention_fwd"] != \
                L * st["prefill_dispatches"] or \
                launches["rms_norm_fused"] == 0 or any(launches_int8.values()):
            raise AssertionError(f"engine_obs: launches {launches}, int8 "
                                 f"{launches_int8} ({st})")
        execs = {k: st[k] for k in st if k.endswith("_executables")}
        rec["traced"] = {
            "window_s": window_s, **obs_times(walls, host),
            "engine_steps": st["engine_steps"],
            "fused_dispatches": st["fused_dispatches"],
            "prefill_dispatches": st["prefill_dispatches"],
            "graph_replays": st["graph_replays"], "executables": execs,
            "latency": lat, "health": st["health"],
            "roofline": st["roofline"], "slo": st["slo"],
            "rates": st["rates"], "prometheus_samples": samples,
            "request_metrics": [dataclasses.asdict(o.metrics)
                                for o in outs],
            "timeline_events": sum(len(o.trace.events) for o in outs)}
        rec["launches"] = launches
        rec["launches_int8"] = launches_int8
        if not all(named.values()):
            # the graph replays' kernels went unnamed: hold the names on an
            # eager engine's traced pass
            eager = obs_engine(params, cfg, dev, _eager=True)
            eager.warm_decode()
            eager.warm_swap()
            obs_pass(eager, warm_prompts)
            with eager.trace(os.path.join(root, "eager"), device=True) as ep:
                obs_pass(eager, prompts[:2])
            n_e, names_e = device_kernels(ep.device_trace_path)
            named_e = {k: sum(k in n for n in names_e) for k in OBS_KERNELS}
            rec["device_trace"]["named_eager"] = named_e
            rec["device_trace"]["kernel_events_eager"] = n_e
            if not all(named_e.values()):
                raise AssertionError(f"engine_obs: eager device trace names "
                                     f"{named_e}")
            del eager
            rec["left_after_eager_mib"] = released("the eager engine")
        # (3) the same prompts untraced: bitwise the same tokens, programs
        bare = obs_engine(params, cfg, dev, request_tracing=False)
        bare.warm_decode()
        bare.warm_swap()
        obs_pass(bare, warm_prompts)
        bouts, bwalls, bhost = obs_pass(bare, prompts)
        bst = bare.stats()
        if [o.token_ids for o in bouts] != [o.token_ids for o in outs] or \
                {k: bst[k] for k in execs} != execs or \
                bst["graph_replays"] != st["graph_replays"] or \
                any(o.trace is not None for o in bouts):
            raise AssertionError(f"engine_obs: the untraced pass differs "
                                 f"({bst})")
        rec["untraced"] = {**obs_times(bwalls, bhost), "executables": execs,
                           "graph_replays": bst["graph_replays"],
                           "identical_streams": len(bouts)}
        # (4) the tracing account: off / on / on / off on fresh prompts
        runs = [obs_pass(e, ps)[1:] for e, ps in
                ((bare, over1), (traced, over1), (traced, over2),
                 (bare, over2))]
        off_w = [x for i in (0, 3) for x in runs[i][0]]
        on_w = [x for i in (1, 2) for x in runs[i][0]]
        off_h = [x for i in (0, 3) for x in runs[i][1]]
        on_h = [x for i in (1, 2) for x in runs[i][1]]
        rec["overhead"] = {
            "order": "off/on/on/off", "passes": [obs_times(w, h)
                                                 for w, h in runs],
            "off_median_ms": 1e3 * float(np.median(off_w)),
            "on_median_ms": 1e3 * float(np.median(on_w)),
            "ratio": float(np.median(on_w) / np.median(off_w)),
            "off_host_median_ms": 1e3 * float(np.median(off_h)),
            "on_host_median_ms": 1e3 * float(np.median(on_h)),
            "host_ratio": float(np.median(on_h) / np.median(off_h)),
            "off_mean_ms": 1e3 * float(np.mean(off_w)),
            "on_mean_ms": 1e3 * float(np.mean(on_w))}
        # a dropped engine goes at `del`, without the cycle collector
        gone = weakref.ref(traced)
        collecting = gc.isenabled()
        gc.disable()
        try:
            del traced, prof
            freed = gone() is None
        finally:
            if collecting:
                gc.enable()
        if not freed:
            raise AssertionError("engine_obs: the dropped engine outlived "
                                 "`del` with the collector off")
        del bare
        rec["left_after_release_mib"] = released("the traced and untraced "
                                                 "engines")
        # (5) health under forced pool pressure, 2 layers of the same width
        cfg2 = dataclasses.replace(cfg, num_layers=2)
        params2 = {**params, "blocks": {k: v[:2] for k, v in
                                        params["blocks"].items()}}
        eng = obs_engine(params2, cfg2, dev, admission="optimistic",
                         preempt="recompute",
                         fault_plan=FaultPlan(pressure_steps=OBS_PRESSURE))
        eng.warm_decode()
        eng.warm_swap()
        pouts, _, _ = obs_pass(eng, prompts)
        h = eng.health()
        pst = eng.stats()
        gauge = eng.metrics.snapshot()["gauges"]["engine_health"]
        if pst["preemptions"] == 0 or h["state"] == "ok" or \
                h["signals"]["preemption"]["state"] == "ok" or \
                not any(r.startswith("preemption") for r in h["reasons"]) \
                or gauge != HEALTH_CODES[h["state"]] or \
                any(len(o.token_ids) != MAX_NEW for o in pouts):
            raise AssertionError(f"engine_obs: pressure {pst['preemptions']} "
                                 f"preemptions, health {h}, gauge {gauge}")
        rec["pressure"] = {"layers": 2, "pressure_steps": OBS_PRESSURE,
                           "preemptions": pst["preemptions"],
                           "rates": pst["rates"]["preemptions_per_sec"],
                           "health": {k: h[k] for k in ("state", "code",
                                                        "reasons")},
                           "engine_health_gauge": gauge}
        del eng, params2
        rec["left_after_pressure_mib"] = released("the pressure engine")
    finally:
        shutil.rmtree(root)
    return dict(enumerate(outs)), rec


# ---------------------------------------------------------------------------
# phase 6h: the engine fleet and the front door at Llama-3-8B width
# ---------------------------------------------------------------------------

# (a) the first FLEET_SESSIONS phase-3 prompts x MAX_NEW, then each prompt +
# its reply + FLEET_EXTRA seeded tokens x MAX_NEW: an odd count of
# sessions, so round robin's turn 2 lands every session on the other replica
FLEET_SESSIONS, FLEET_EXTRA = 7, 64
# (b) replica 0 decodes FLEET_LONG_NEW tokens while replica 1 prefills a
# prompt in the bucket neither replica built (2048); in the second pass
# replica 0 serves FLEET_SWAP_REQUESTS requests x FLEET_SWAP_NEW under
# optimistic admission with swap preemption, its pool forced short at
# FLEET_SWAP_PRESSURE of its steps
FLEET_LONG_NEW, FLEET_NEW_LEN = 512, 1500
FLEET_SWAP_REQUESTS, FLEET_SWAP_NEW = 4, 128
FLEET_SWAP_PRESSURE = tuple(range(8, 128, 4))
FLEET_WAIT_S = 600.0    # a wedged loop fails the phase, it does not hang it


def fleet_knobs(dev):
    """Phase 3's bucketed knobs (each replica)."""
    return dict(num_slots=8, page_size=16, max_model_len=2048,
                prefill_buckets=SERVE_BUCKETS, device=dev)


def fleet_sessions(fleet, first, extra, vocab):
    """Turn 1, then turn 2, of every session through the fleet's loops
    (submit, result, drain), the median wall of `select` timed while turn
    2 runs.  Returns (turn-1 outputs, turn-2 outputs, turn-2 prompts, a
    record)."""
    t0 = time.perf_counter()
    h1 = [fleet.submit(p, session=f"s{i}", max_new_tokens=MAX_NEW)
          for i, p in enumerate(first)]
    o1 = [fleet.result(h, timeout=FLEET_WAIT_S) for h in h1]
    conv = [np.concatenate([p, np.asarray(o.token_ids, np.int32), x])
            for p, o, x in zip(first, o1, extra)]
    h2 = [fleet.submit(c, session=f"s{i}", max_new_tokens=MAX_NEW)
          for i, c in enumerate(conv)]
    sel = []
    while len(sel) < 32 and not all(fleet.progress(h)["finished"]
                                    for h in h2):
        s = time.perf_counter()
        fleet.select(conv[0], session="s0", policy="affinity")
        sel.append(time.perf_counter() - s)
    o2 = [fleet.result(h, timeout=FLEET_WAIT_S) for h in h2]
    if not fleet.drain(FLEET_WAIT_S):
        raise AssertionError("engine_fleet: the fleet did not drain")
    wall = time.perf_counter() - t0
    fleet.check_invariants()
    for o in o1 + o2:
        if o is None or o.finish_reason != "length" or \
                len(o.token_ids) != MAX_NEW or \
                not all(0 <= t < vocab for t in o.token_ids):
            raise AssertionError(f"engine_fleet: {o}")
    ttft = [o.metrics.ttft_s for o in o2]
    rec = {"replicas": [h.label for h in h1], "turn2_replicas":
           [h.label for h in h2], "generated_tokens": 2 * len(first) *
           MAX_NEW, "wall_s": wall,
           "tokens_per_s": 2 * len(first) * MAX_NEW / wall,
           "turn2_ttft_median_s": float(np.median(ttft)),
           "turn2_ttft_max_s": float(np.max(ttft)), "turn2_ttft_s": ttft,
           "turn2_cached_tokens": [o.cached_tokens for o in o2],
           "select_samples": len(sel),
           "select_median_ms": 1e3 * float(np.median(sel)) if sel else None}
    return o1, o2, conv, rec


def fleet_programs(fleet, single=None):
    """Each replica's program counts: its decode-side, copy and swap
    programs within SERVE_PROGRAM_BUDGET, one prefill program per bucket
    it prefilled and the chunk program where it ran prefix-hit tails; with
    `single` (the one-replica fleet's counts after the same traffic), no
    count above it: replication adds no program.  The prefill key is
    reported beside the budget, not held to it: bucketed traffic over two
    buckets with hit tails builds three prefill programs, on one engine as
    on a replica (ROADMAP Queue 2 item 10; 6f's baseline reports the
    same)."""
    from paddle_tpu_torch.analysis.registry import over_budget
    out = {}
    for label, eng in fleet.engines.items():
        st = locked_stats(eng)
        counts = {k: st[k] for k in st if k.endswith("_executables")}
        over = over_budget(st)
        built = sum(r.startswith("prefill:") or r == "chunk"
                    for r in eng._programs)
        if set(over) - {"prefill_executables", "total_executables"} or \
                counts["prefill_executables"] != built or \
                counts["prefill_executables"] > len(SERVE_BUCKETS) + 1 or \
                (single is not None and any(counts[k] > n
                                            for k, n in single.items())):
            raise AssertionError(f"engine_fleet {label}: programs {counts}, "
                                 f"over the budget {over}, one engine's "
                                 f"{single}")
        # the programs built in the loop, and their warm-up and capture
        out[label] = {**counts, "over_budget": over, "build_s": {
            r: prog.build_s for r, prog in eng._programs.items()
            if prog.built}}
    return out


def locked_stats(eng):
    """`stats()` between two steps of the engine's loop."""
    with eng._serve_lock:
        return eng.stats()


def engine_fleet(params, cfg, prompts, dev, smi):
    """Phase 6h (see the module docstring): the phase's record, with its
    launch counts."""
    import gc
    import shutil
    import tempfile

    import torch
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.inference.faults import FaultPlan
    from paddle_tpu_torch.inference.router import (EngineFleet,
                                                   _adopt_executables)
    V = cfg.vocab_size
    knobs = fleet_knobs(dev)
    rng = np.random.RandomState(18)
    first = prompts[:FLEET_SESSIONS]
    extra = [rng.randint(0, V, FLEET_EXTRA).astype(np.int32) for _ in first]
    long_p = rng.randint(0, V, PROMPT_LENS[0]).astype(np.int32)
    new_p = rng.randint(0, V, FLEET_NEW_LEN).astype(np.int32)
    swap_ps = [rng.randint(0, V, n).astype(np.int32)
               for n in PROMPT_LENS[:FLEET_SWAP_REQUESTS]]
    door_p = rng.randint(0, V, 200).astype(np.int32)
    drop_p = rng.randint(0, V, 100).astype(np.int32)
    weight_bytes = sum(t.nbytes for t in params["blocks"].values()) + \
        sum(t.nbytes for k, t in params.items() if k != "blocks")

    def result(eng, rid):
        out = eng.result(rid, timeout=FLEET_WAIT_S)
        if out is None:
            raise AssertionError(f"engine_fleet: request {rid} unfinished")
        return out

    def built_fleet(engine_kwargs=knobs, **kw):
        gc.collect()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated(dev)
        fleet = EngineFleet(params, cfg, engine_kwargs=engine_kwargs, **kw)
        grew = torch.cuda.memory_allocated(dev) - before
        if not fleet.shared_executables():
            raise AssertionError("engine_fleet: replicas on another copy "
                                 "of the weights")
        fleet.warm()
        return fleet, grew

    def release():
        # the loop threads' cuBLAS handles keep a workspace on each stream
        # they ran on (the engine's and the capture stream) until cleared
        gc.collect()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated(dev)

    held = release()
    rec = {"nvidia_smi": smi, "weight_bytes": weight_bytes}
    torch.cuda.synchronize()
    K.reset_launches()
    t_run = time.perf_counter()

    # (a) one replica, affinity; then its solo runs of (b)'s requests
    fleet, grew1 = built_fleet(replicas=1)
    with fleet:
        a1_1, a1_2, conv, r = fleet_sessions(fleet, first, extra, V)
        r["programs"] = fleet_programs(fleet)
        single = {k: v for k, v in r["programs"]["engine0"].items()
                  if k.endswith("_executables")}
        eng = fleet.engines["engine0"]
        solo_long = result(eng, eng.submit(long_p,
                                           max_new_tokens=FLEET_LONG_NEW))
        solo_new = result(eng, eng.submit(new_p, max_new_tokens=MAX_NEW))
        rids = [eng.submit(p, max_new_tokens=FLEET_SWAP_NEW)
                for p in swap_ps]
        solo_swap = [result(eng, i) for i in rids]
    r["memory_grew_gib"] = grew1 / 2 ** 30
    rec["a_affinity_1"] = r
    del fleet, eng

    # (a) two replicas, affinity: one copy of the weights; then (b), (d)
    fleet, grew2 = built_fleet(replicas=2)
    if grew2 > weight_bytes / 2:
        raise AssertionError(f"engine_fleet: two replicas took "
                             f"{grew2 / 2**30:.2f} GiB, a copy of the "
                             f"weights is {weight_bytes / 2**30:.2f}")
    e0, e1 = fleet.engines.values()
    with fleet:
        a2_1, a2_2, _, r = fleet_sessions(fleet, first, extra, V)
        r["programs"] = fleet_programs(fleet, single)
        r["memory_grew_gib"] = grew2 / 2 ** 30
        rec["a_affinity_2"] = r
        # (b) replica 1 captures bucket 2048 in its loop while replica 0
        # decodes
        if any(f"prefill:{SERVE_BUCKETS[-1]}" in e._programs
               for e in (e0, e1)):
            raise AssertionError("engine_fleet: bucket 2048 already built")
        h0 = e0.submit(long_p, max_new_tokens=FLEET_LONG_NEW)
        while len(e0.progress(h0)["token_ids"]) < 8:
            time.sleep(0.001)
        at = len(e0.progress(h0)["token_ids"])
        t0 = time.perf_counter()
        o_new = result(e1, e1.submit(new_p, max_new_tokens=MAX_NEW))
        new_s = time.perf_counter() - t0
        during = len(e0.progress(h0)["token_ids"]) - at
        o_long = result(e0, h0)
        if o_long.token_ids != solo_long.token_ids or \
                o_new.token_ids != solo_new.token_ids or \
                not e1._programs[f"prefill:{SERVE_BUCKETS[-1]}"].built:
            raise AssertionError("engine_fleet b: streams differ from the "
                                 "solo runs")
        rec["b_lazy_capture"] = {"decode_tokens_during_capture": during,
                                 "capture_request_s": new_s,
                                 "streams_equal_solo": True}
        # (d) the front door over this fleet, on loopback
        rec["d_front_door"] = front_door(fleet, door_p, drop_p)
    rec["b_lazy_capture"]["programs"] = fleet_programs(fleet)
    del fleet, e0, e1

    # (a) two replicas, round robin
    fleet, _ = built_fleet(replicas=2, router="round_robin")
    with fleet:
        rr_1, rr_2, _, r = fleet_sessions(fleet, first, extra, V)
        r["programs"] = fleet_programs(fleet, single)
    rec["a_round_robin_2"] = r
    del fleet

    # (b) second pass: replica 0 swaps under forced pressure meanwhile
    e0 = LLMEngine(params, cfg, admission="optimistic", preempt="swap",
                   fault_plan=FaultPlan(pressure_steps=FLEET_SWAP_PRESSURE),
                   **knobs)
    e1 = LLMEngine(params, cfg, **knobs)
    _adopt_executables(e1, e0)
    fleet = EngineFleet(engines=[e0, e1])
    fleet.warm()
    with fleet:
        rids = [e0.submit(p, max_new_tokens=FLEET_SWAP_NEW) for p in swap_ps]
        deadline = time.monotonic() + FLEET_WAIT_S
        while locked_stats(e0)["preemptions"] < 2:
            if time.monotonic() > deadline:
                raise AssertionError("engine_fleet b: no preemption")
            time.sleep(0.001)
        swaps = locked_stats(e0)["swap_out_dispatches"]
        o_new = result(e1, e1.submit(new_p, max_new_tokens=MAX_NEW))
        swaps = locked_stats(e0)["swap_out_dispatches"] - swaps
        o_swap = [result(e0, i) for i in rids]
        fleet.check_invariants()
    st = e0.stats()
    if [o.token_ids for o in o_swap] != [o.token_ids for o in solo_swap] \
            or o_new.token_ids != solo_new.token_ids or \
            st["preempt_swaps"] == 0 or st["pages_in_use"] or st["swapped"]:
        raise AssertionError(f"engine_fleet b (swap): streams differ from "
                             f"the solo runs or no swap ({st})")
    rec["b_lazy_capture"]["swap_pass"] = {
        "swap_outs_during_capture": swaps, "streams_equal_solo": True,
        **{k: st[k] for k in ("preemptions", "preempt_swaps",
                              "swapped_pages", "swap_out_dispatches",
                              "swap_in_dispatches")}}
    del fleet, e0, e1

    # (c) disaggregated prefill/decode over one store directory
    root = tempfile.mkdtemp()
    try:
        fleet, _ = built_fleet(roles="P:D",
                               engine_kwargs=dict(knobs, spill_dir=root))
        with fleet:
            hs = [fleet.submit(p, session=f"s{i}", max_new_tokens=MAX_NEW)
                  for i, p in enumerate(first)]
            dis = [fleet.result(h, timeout=FLEET_WAIT_S) for h in hs]
            if not fleet.drain(FLEET_WAIT_S) or None in dis:
                raise AssertionError("engine_fleet c: unfinished requests")
            fleet.check_invariants()
        fst = fleet.stats()["disagg"]
        de = fleet.engines[fleet.decode_pool[0]]
        full = [((p.size - 1) // 16) * 16 for p in first]
        cached = [o.cached_tokens for o in dis]
        if fst["handoffs"] != len(first) or \
                any(c < f for c, f in zip(cached, full)) or \
                de.stats()["kv_tier"]["restores"] == 0:
            raise AssertionError(f"engine_fleet c: {fst}, cached {cached} "
                                 f"of {full}")
        rec["c_disagg"] = {**fst, "cached_tokens": cached,
                           "decode_kv_tier": de.stats()["kv_tier"],
                           "programs": fleet_programs(fleet)}
        del fleet, de
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    rec["run_s"] = time.perf_counter() - t_run
    rec["launches"], rec["launches_int8"] = K.launches(), K.launches_int8()
    no_composed("engine_fleet")
    la = rec["launches"]
    if not (la["paged_prefill_attention_kernel"] and
            la["flash_attention_fwd"] and la["rms_norm_fused"]) or \
            la["paged_attention_kernel"] or any(rec["launches_int8"].values()):
        raise AssertionError(f"engine_fleet: launches {la}")

    # the streams: turn 1 bitwise in the three fleets, turn 2 bitwise in
    # the two affinity fleets, which reuse each session's whole turn-1 KV;
    # round robin re-prefills (no cached token), held with affinity against
    # the dense forward's first token where its margin exceeds 0.05
    t1 = [[o.token_ids for o in run] for run in (a1_1, a2_1, rr_1)]
    if not t1[0] == t1[1] == t1[2] or \
            [o.token_ids for o in a1_2] != [o.token_ids for o in a2_2]:
        raise AssertionError("engine_fleet a: streams differ between fleets")
    kv = [p.size + MAX_NEW - 1 for p in first]
    for name in ("a_affinity_1", "a_affinity_2"):
        if rec[name]["turn2_cached_tokens"] != kv:
            raise AssertionError(f"engine_fleet {name}: turn-2 cached "
                                 f"{rec[name]['turn2_cached_tokens']}, the "
                                 f"turn-1 KV {kv}")
    if any(rec["a_round_robin_2"]["turn2_cached_tokens"]):
        raise AssertionError("engine_fleet: round robin hit the cache")
    picks = forward_picks(params, cfg, dict(enumerate(conv)))
    rec["a_round_robin_2"]["first_token"] = check_first_tokens(
        picks, dict(enumerate(rr_2)), "round robin turn 2")
    rec["a_affinity_2"]["first_token"] = check_first_tokens(
        picks, dict(enumerate(a2_2)), "affinity turn 2")
    rec["a_round_robin_2"]["turn2_agreement_with_affinity"] = agreement(
        dict(enumerate(a2_2)), dict(enumerate(rr_2)))
    picks = forward_picks(params, cfg, dict(enumerate(first)))
    rec["c_disagg"]["first_token"] = check_first_tokens(
        picks, dict(enumerate(dis)), "disaggregated")
    rec["c_disagg"]["agreement_with_a"] = agreement(
        dict(enumerate(a2_1)), dict(enumerate(dis)))
    left = release() - held
    if left > RELEASE_SLACK:
        raise AssertionError(f"engine_fleet: the phase's engines left "
                             f"{left / 2**20:.1f} MiB allocated")
    rec["left_after_release_mib"] = left / 2 ** 20
    return rec


def front_door(fleet, prompt, drop_prompt):
    """Phase 6h (d): `ServingFrontend` over `fleet` on loopback.  The
    fleet serves `prompt` once (its pages then cached on one replica); the
    door's completion and its SSE chat of the same prompt, which the same
    replica serves from the same cached prefix, must equal a second
    `fleet.result` of it; a client that drops mid-stream frees its pages;
    /metrics and /healthz answer through the same port."""
    import http.client
    import socket

    from paddle_tpu_torch.inference.frontend import ServingFrontend

    def post(door, path, payload):
        conn = http.client.HTTPConnection("127.0.0.1", door.port,
                                          timeout=FLEET_WAIT_S)
        conn.request("POST", path, json.dumps(payload),
                     {"Content-Type": "application/json"})
        return conn, conn.getresponse()

    def fleet_run():
        return fleet.result(fleet.submit(prompt, max_new_tokens=16),
                            timeout=FLEET_WAIT_S)

    rec = {}
    first = fleet_run()
    with ServingFrontend(fleet) as door:
        conn, resp = post(door, "/v1/completions",
                          {"prompt": prompt.tolist(), "max_tokens": 16})
        body = json.loads(resp.read())
        conn.close()
        again = fleet_run()
        toks = body["choices"][0]["token_ids"]
        t0 = time.perf_counter()
        conn, resp = post(door, "/v1/chat/completions",
                          {"messages": [{"role": "user",
                                         "content": prompt.tolist()}],
                           "max_tokens": 16, "stream": True})
        streamed, first_frame_s, final = [], None, None
        for line in resp:
            line = line.strip()
            if not line.startswith(b"data: ") or line == b"data: [DONE]":
                continue
            frame = json.loads(line[len(b"data: "):])
            delta = frame["choices"][0].get("delta")
            if delta is None:
                final = frame
                continue
            if first_frame_s is None:
                first_frame_s = time.perf_counter() - t0
            streamed += delta["token_ids"]
        conn.close()
        if resp.status != 200 or toks != again.token_ids or \
                streamed != again.token_ids or final is None or \
                final["choices"][0]["message"]["token_ids"] != streamed:
            raise AssertionError(f"engine_fleet d: door {toks}, stream "
                                 f"{streamed}, fleet {again.token_ids}")
        rec.update(completion_replica=body["engine"],
                   cached_tokens=body["usage"]["cached_tokens"],
                   first_run_equal=first.token_ids == toks,
                   sse_first_frame_s=first_frame_s, tokens_equal=True)
        # a client that hangs up mid-stream
        fleet.drain(FLEET_WAIT_S)
        before = {l: (locked_stats(e)["aborted_requests"],
                      e.cache.pages_in_use())
                  for l, e in fleet.engines.items()}
        payload = json.dumps({"prompt": drop_prompt.tolist(),
                              "max_tokens": 512, "stream": True}).encode()
        sock = socket.create_connection(("127.0.0.1", door.port),
                                        timeout=FLEET_WAIT_S)
        sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: door\r\n"
                     b"Content-Type: application/json\r\nContent-Length: " +
                     str(len(payload)).encode() + b"\r\n\r\n" + payload)
        got = b""
        while b"data: " not in got:
            got += sock.recv(4096)
        sock.shutdown(socket.SHUT_RDWR)
        sock.close()
        deadline = time.monotonic() + FLEET_WAIT_S
        while not any(locked_stats(e)["aborted_requests"] > before[l][0]
                      for l, e in fleet.engines.items()):
            if time.monotonic() > deadline:
                raise AssertionError("engine_fleet d: the dropped client's "
                                     "request was never aborted")
            time.sleep(0.01)
        if not fleet.drain(FLEET_WAIT_S):
            raise AssertionError("engine_fleet d: the fleet did not drain")
        after = {l: e.cache.pages_in_use() for l, e in fleet.engines.items()}
        if after != {l: b[1] for l, b in before.items()}:
            raise AssertionError(f"engine_fleet d: pages in use {after}, "
                                 f"before the request {before}")
        rec["pages_in_use_after_drop"] = after
        # the observability routes through the same port
        conn = http.client.HTTPConnection("127.0.0.1", door.port, timeout=60)
        conn.request("GET", "/metrics",
                     headers={"Accept": "application/openmetrics-text"})
        resp = conn.getresponse()
        text = resp.read().decode()
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", door.port, timeout=60)
        conn.request("GET", "/healthz")
        hresp = conn.getresponse()
        health = json.loads(hresp.read())
        conn.close()
        if resp.status != 200 or not text.endswith("# EOF\n") or \
                "llm_fleet_" not in text or 'engine="engine1"' not in text \
                or hresp.status != 200 or health["state"] not in ("ok",
                                                                  "degraded"):
            raise AssertionError(f"engine_fleet d: /metrics {resp.status}, "
                                 f"/healthz {hresp.status} {health}")
        rec.update(metrics_lines=len(text.splitlines()),
                   fleet_series=sum(ln.startswith("llm_fleet_")
                                    for ln in text.splitlines()),
                   health=health["state"])
    return rec


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
# phase 8b: dense KV-cache generation at Llama-3-8B width
# ---------------------------------------------------------------------------

GEN_BATCH, GEN_PROMPT = 8, 512
F32_TIE = 1e-3          # float32, TF32 off: two paths differ by ~1e-5


def last_logits(params, cfg, ids):
    """The dense forward's logits [B, V] (float32) at each row's last
    position."""
    import torch
    from paddle_tpu_torch.models import gpt
    with torch.no_grad():
        x, head, _ = gpt.backbone(params, ids, cfg)
        return gpt.head_logits(x[:, -1], params, cfg).float()


def picks_and_margins(logits):
    import torch
    top2 = torch.topk(logits, 2)
    return (top2.indices[:, 0].tolist(),
            (top2.values[:, 0] - top2.values[:, 1]).tolist())


def first_tie(params, cfg, prompt, want, got, tie):
    """Where two greedy streams of one prompt first differ: (position, the
    top-2 margin of the dense forward over the prompt and `want`'s tokens
    before it); raises unless that margin is below `tie`.  None when equal."""
    import torch
    want, got = list(want), list(got)
    if want == got:
        return None
    i = next((j for j, (a, b) in enumerate(zip(want, got)) if a != b),
             min(len(want), len(got)))
    seq = torch.as_tensor(np.concatenate([np.asarray(prompt),
                                          np.asarray(want[:i])]))[None]
    _, margins = picks_and_margins(last_logits(params, cfg,
                                               seq.to(params["wte"].device)))
    if margins[0] >= tie:
        raise AssertionError(f"streams differ at token {i} where the "
                             f"forward's top-2 margin {margins[0]:.3g} is "
                             f"no tie: {want} against {got}")
    return {"position": i, "margin": margins[0]}


def generate_phase(params, cfg, dev):
    """Phase 8b (see the module docstring): `generate` at Llama-3-8B width
    in bf16, then float32 at 2 layers against the fused bucketed engine."""
    import torch
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.models import gpt
    rng = np.random.RandomState(8)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (
        GEN_BATCH, GEN_PROMPT))).to(dev)
    t0 = time.perf_counter()
    first = gpt.generate(params, ids, cfg, max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    before = gpt.generate_cache_stats()
    K.reset_launches()
    out = gpt.generate(params, ids, cfg, max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    launches = K.launches()
    no_composed("generate")
    after = gpt.generate_cache_stats()
    L = cfg.num_layers
    if after["compiles"] != before["compiles"] or \
            after["replays"] != before["replays"] + MAX_NEW:
        raise AssertionError(f"generate: a second call compiled or did not "
                             f"replay ({before} -> {after})")
    if not torch.equal(out, first):
        raise AssertionError("generate: two calls differ")
    if launches["flash_attention_fwd"] != L or \
            launches["rms_norm_fused"] != (2 * L + 1) * MAX_NEW:
        raise AssertionError(f"generate launches {launches}")
    picks, margins = picks_and_margins(last_logits(params, cfg, ids))
    checks = []
    for b, (pick, margin) in enumerate(zip(picks, margins)):
        tok = int(out[b, GEN_PROMPT])
        if margin > 0.05 and tok != pick:
            raise AssertionError(f"generate row {b}: first token {tok} != "
                                 f"the forward's {pick} (margin {margin})")
        checks.append({"row": b, "generate": tok, "forward": pick,
                       "margin": margin,
                       "result": "match" if tok == pick else "tie"})
    gen_ms = time_ms(lambda: gpt.generate(params, ids, cfg,
                                          max_new_tokens=MAX_NEW),
                     iters=5, warmup=1)
    prefill_ms = time_ms(lambda: gpt.generate(params, ids, cfg,
                                              max_new_tokens=1),
                         iters=5, warmup=1)
    # EOS: row 0's fourth new token; every row freezes after its first one
    eos = int(out[0, GEN_PROMPT + 3])
    frozen = gpt.generate(params, ids, cfg, max_new_tokens=MAX_NEW,
                          eos_token_id=eos).cpu()
    new, plain = frozen[:, GEN_PROMPT:], out[:, GEN_PROMPT:].cpu()
    for b in range(GEN_BATCH):
        hit = (new[b] == eos).nonzero()
        if b == 0 and (not len(hit) or int(hit[0]) > 3):
            raise AssertionError("generate: row 0 did not stop at its EOS")
        if len(hit):
            i = int(hit[0])
            if not (bool((new[b, i:] == eos).all()) and
                    torch.equal(new[b, :i], plain[b, :i])):
                raise AssertionError(f"generate row {b}: not frozen at EOS")
    rec = {"model": "llama3_8b", "layers": L, "dtype": "bf16",
           "batch": [GEN_BATCH, GEN_PROMPT], "max_new": MAX_NEW,
           "first_call_s": build_s, "cache": after,
           "generate_ms": gen_ms, "prefill_ms": prefill_ms,
           "decode_step_ms": (gen_ms - prefill_ms) / (MAX_NEW - 1),
           "tokens_per_s": GEN_BATCH * MAX_NEW / (gen_ms / 1e3),
           "launches": launches, "first_token": checks,
           "eos": {"token": eos, "rows_stopped": int(
               (new == eos).any(dim=1).sum())}}
    gpt._generate_cache.clear()
    return rec


def generate_f32_vs_engine(dev):
    """float32 (TF32 off), Llama-3-8B width with 2 layers: `generate`'s
    tokens against the fused bucketed engine's streams for the same 8
    prompts, equal but for ties of the dense forward (F32_TIE)."""
    import gc

    import torch
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.models import gpt
    cfg = gpt.llama3_8b()
    cfg.num_layers = 2
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                             dev)
    rng = np.random.RandomState(9)
    ids = rng.randint(0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT))
    toks = gpt.generate(params, torch.from_numpy(ids).to(dev), cfg,
                        max_new_tokens=MAX_NEW)[:, GEN_PROMPT:].cpu()
    eng = LLMEngine(params, cfg, num_slots=8, page_size=16,
                    max_model_len=2048, prefill_buckets=SERVE_BUCKETS,
                    device=dev)
    rids = [eng.add_request(p, max_new_tokens=MAX_NEW) for p in ids]
    outs = eng.run()
    ties = {}
    for b, rid in enumerate(rids):
        tie = first_tie(params, cfg, ids[b], toks[b].tolist(),
                        outs[rid].token_ids, F32_TIE)
        if tie:
            ties[b] = tie
    rec = {"model": "llama3_8b", "layers": 2, "dtype": "float32",
           "identical_streams": GEN_BATCH - len(ties), "of": GEN_BATCH,
           "ties": ties, "engine_fused_dispatches":
               eng.stats()["fused_dispatches"]}
    del eng, params
    gpt._generate_cache.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phases 13-14: the MoE family at GPT-3 1.3B width
# ---------------------------------------------------------------------------

# Phase 8c: 4 prompts of 512 tokens through the Layer API; generate from
# their first 64 tokens
LAYER_BATCH, LAYER_PROMPT, LAYER_GEN_PROMPT = 4, 512, 64


def grad_mismatches(names, params, ref_grads):
    """Where the Layer API's `.grad` and `torch.autograd.grad` of the same
    loss differ: [{name, why, max_abs_diff}]; [] when every one is bitwise
    equal (or both absent: a leaf the loss does not read)."""
    import torch
    out = []
    for name, p, want in zip(names, params, ref_grads):
        got = p._t.grad
        if got is None or want is None:
            if (got is None) != (want is None):
                out.append({"name": name, "why": "grad present in one"})
        elif not torch.equal(got, want):
            out.append({"name": name, "why": "values",
                        "max_abs_diff": float((got.float() - want.float())
                                              .abs().max())})
    return out


def layer_api(dev, smi):
    """Phase 8c (see the module docstring): `GPTForCausalLM` at Llama-3-8B
    width through the Layer API, held bitwise to the functional path."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.models import gpt
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    paddle.set_device(f"gpu:{dev.index or 0}")
    paddle.seed(0)
    cfg = gpt.llama3_8b()
    cfg.dtype = torch.bfloat16
    model = gpt.GPTForCausalLM(cfg)
    names = ["/".join(p) for p in model._paths]
    params = model.parameters()
    rec = {"model": "llama3_8b", "layers": cfg.num_layers, "dtype": "bf16",
           "parameters": sum(p.size for p in params),
           "parameter_bytes": sum(p._t.numel() * p._t.element_size()
                                  for p in params),
           "batch": [LAYER_BATCH, LAYER_PROMPT],
           "init_s": time.perf_counter() - t0}
    rng = np.random.RandomState(9)
    ids_np = rng.randint(0, cfg.vocab_size, (LAYER_BATCH, LAYER_PROMPT))
    labels_np = np.roll(ids_np, -1, 1)
    labels_np[:, -1] = -100
    ids = paddle.to_tensor(ids_np.astype(np.int32))
    labels = paddle.to_tensor(labels_np.astype(np.int32))
    gpt._generate_cache.clear()
    torch.cuda.synchronize()
    # the counted run: the Layer API's calls only
    K.reset_launches()
    t = time.perf_counter()
    with paddle.no_grad():
        logits = model(ids)
    loss = model(ids, labels)
    loss.backward()
    out = model.generate(ids[:, :LAYER_GEN_PROMPT], max_new_tokens=MAX_NEW)
    torch.cuda.synchronize()
    rec["layer_api_s"] = time.perf_counter() - t
    launches = K.launches()
    no_composed("layer_api")
    L = cfg.num_layers
    # two forwards (rows 2, 3) and generate's prefill (row 2) and its
    # MAX_NEW picks (row 3: the prefill and MAX_NEW - 1 decode steps), as
    # the functional path launches them; one backward (rows 5, 6)
    want = {"flash_attention_fwd": 3 * L,
            "rms_norm_fused": (2 * L + 1) * (2 + MAX_NEW),
            "flash_bwd_dkv": L, "flash_bwd_dq": L}
    want = {k: want.get(k, 0) for k in launches}
    if launches != want:
        raise AssertionError(f"layer_api launches {launches}, want {want}")
    rec["launches"] = launches
    # the functional path on the same tensors (not counted)
    tree = model.params_pytree()
    t = time.perf_counter()
    with torch.no_grad():
        ref_logits = gpt.forward(tree, ids._t, cfg)
    if not torch.equal(logits._t, ref_logits):
        diff = (logits._t.float() - ref_logits.float()).abs().max()
        raise AssertionError(f"layer_api: logits differ from forward's by "
                             f"{float(diff)}")
    del ref_logits
    ref_loss = gpt.loss_fn(tree, ids._t, labels._t, cfg)
    rec["loss"] = float(loss)
    if not torch.equal(loss._t, ref_loss):
        raise AssertionError(f"layer_api: loss {float(loss)} != loss_fn's "
                             f"{float(ref_loss)}")
    leaves = [p._t for p in params]
    ref_grads = torch.autograd.grad(ref_loss, leaves, allow_unused=True)
    del ref_loss
    bad = grad_mismatches(names, params, ref_grads)
    rec["grads_without_use"] = [n for n, g in zip(names, ref_grads)
                                if g is None]
    del ref_grads
    if bad:
        raise AssertionError(f"layer_api: grads differ from "
                             f"torch.autograd.grad of loss_fn: {bad}")
    rec["grads_bitwise"] = len(names) - len(rec["grads_without_use"])
    gpt._generate_cache.clear()
    with torch.no_grad():
        ref_out = gpt.generate(tree, ids._t[:, :LAYER_GEN_PROMPT], cfg,
                               max_new_tokens=MAX_NEW)
    if not torch.equal(out._t, ref_out):
        raise AssertionError("layer_api: generate differs from the "
                             "functional generate")
    picks, margins = picks_and_margins(last_logits(
        tree, cfg, ids._t[:, :LAYER_GEN_PROMPT]))
    checks = []
    for b, (pick, margin) in enumerate(zip(picks, margins)):
        tok = int(out._t[b, LAYER_GEN_PROMPT])
        if margin > 0.05 and tok != pick:
            raise AssertionError(f"layer_api row {b}: first token {tok} != "
                                 f"the forward's {pick} (margin {margin})")
        checks.append({"row": b, "generate": tok, "forward": pick,
                       "margin": margin,
                       "result": "match" if tok == pick else "tie"})
    rec["reference_s"] = time.perf_counter() - t
    rec["first_token"] = checks
    rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["nvidia_smi"] = smi
    gpt._generate_cache.clear()
    # phase 8d takes the forward's logits, the labels and the loss on
    kept = {"logits": logits, "labels": labels, "loss": loss._t.detach()}
    del model, params, leaves, tree, loss, out, ref_out
    torch.cuda.empty_cache()
    return rec, kept


# Phase 8d: the op namespace on the card
OPS_TOP_K, OPS_TOP_P, OPS_DRAWS, OPS_SEED = 50, 0.9, 32, 1234
OPS_LOSS_REL = 1e-5     # composed loss vs loss_fn: f32 sums in other orders
OPS_GRAD_TOL = dict(atol=1e-9, rtol=1e-4)   # vs (softmax - one-hot) / count


def op_cases():
    """`tests/torch_op_cases.py`, the CPU twins' table (numpy only)."""
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_op_cases
    return torch_op_cases


def ops_table_on_card(paddle, place):
    """Phase 8d (a): every twin case on the card against the port on the
    CPU, then creation and random ops on the card.  Returns the record."""
    import torch
    C = op_cases()
    worst = {name: 0.0 for name in C.TABLES}
    for name, table in C.TABLES.items():
        for case in table:
            worst[name] = max(worst[name], C.port_on_device(paddle, case, place))
    made = [paddle.zeros([2]), paddle.arange(5), paddle.full([2], 7),
            paddle.eye(3), paddle.linspace(0, 1, 4), paddle.tril_indices(4, 4),
            paddle.rand([3]), paddle.randn([3]), paddle.randint(0, 9, [3]),
            paddle.randperm(8), paddle.uniform([3], seed=3),
            paddle.multinomial(paddle.full([9], 1.0), 2)]
    where = {str(t.place) for t in made}
    if where != {str(paddle.CUDAPlace(torch.cuda.current_device()))}:
        raise AssertionError(f"ops_api: creation/random ops landed on {where}")

    def draw():
        return torch.cat([paddle.rand([256])._t, paddle.randn([256])._t,
                          paddle.randint(0, 1000, [256])._t.float()])
    paddle.seed(OPS_SEED)
    a = draw()
    paddle.seed(OPS_SEED)
    b = draw()
    paddle.seed(OPS_SEED + 1)
    c = draw()
    k = paddle.uniform([256], seed=7)._t
    paddle.rand([4096])
    k2 = paddle.uniform([256], seed=7)._t
    if not torch.equal(a, b) or torch.equal(a, c) or not torch.equal(k, k2):
        raise AssertionError("ops_api: seeded draws do not repeat on the card")
    return {"cases": {n: len(t) for n, t in C.TABLES.items()},
            "max_abs_diff_vs_cpu": worst, "outputs_on": sorted(where),
            "seed_repeats": True}


def composed_loss(paddle, logits, labels):
    """The shifted-label cross entropy from top-level ops over the
    forward's logits (labels already shifted, -100 ignored): (the mean
    loss, the float32 logits it differentiates)."""
    lf = paddle.cast(logits, "float32")
    lf.stop_gradient = False
    valid = paddle.not_equal(labels, paddle.full_like(labels, -100))
    safe = paddle.cast(paddle.where(valid, labels, paddle.zeros_like(labels)),
                       "int64")
    lse = paddle.logsumexp(lf, axis=-1)
    picked = paddle.take_along_axis(lf, paddle.unsqueeze(safe, -1), axis=-1)
    per = paddle.where(valid, lse - paddle.squeeze(picked, -1),
                       paddle.zeros_like(lse))
    count = paddle.sum(paddle.cast(valid, "float32"))
    return paddle.sum(per) / count, lf


def top_p_draws(paddle, last, seed):
    """OPS_DRAWS tokens a row of `last` [B, V] by top-k (OPS_TOP_K) then
    top-p (OPS_TOP_P) sampling under `paddle.seed(seed)`: [B, OPS_DRAWS]."""
    lf = paddle.cast(last, "float32")
    vals, idx = paddle.topk(lf, OPS_TOP_K, axis=-1)
    srt = paddle.sort(vals, axis=-1, descending=True)
    if not paddle.equal_all(srt, vals).item():
        raise AssertionError("ops_api: topk's values are not sorted")
    probs = paddle.exp(srt - paddle.logsumexp(srt, axis=-1, keepdim=True))
    before = paddle.cumsum(probs, axis=-1) - probs
    kept = paddle.where(before < OPS_TOP_P, probs, paddle.zeros_like(probs))
    paddle.seed(seed)
    pos = paddle.multinomial(kept, OPS_DRAWS, replacement=True)
    return paddle.take_along_axis(idx, pos, axis=-1)


def ops_api(dev, smi, kept):
    """Phase 8d (see the module docstring): the op table on the card, then
    the ops over 8c's Llama-3-8B logits."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate import kernels as K
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    place = f"gpu:{dev.index or 0}"
    paddle.set_device(place)
    K.reset_launches()
    rec = {"table": ops_table_on_card(paddle, place)}
    rec["table_s"] = time.perf_counter() - t0
    paddle.set_device(place)
    # (b) at Llama-3-8B width: 8c's logits [4, 512, 128256] bf16
    t = time.perf_counter()
    logits, labels = kept["logits"], kept["labels"]
    rec["logits"] = {"shape": logits.shape, "dtype": logits.dtype.name}
    loss, lf = composed_loss(paddle, logits, labels)
    want = float(kept["loss"])
    rel = abs(float(loss) - want) / abs(want)
    rec["loss"] = {"composed": float(loss), "loss_fn": want, "rel_err": rel,
                   "tol": OPS_LOSS_REL}
    if rel > OPS_LOSS_REL:
        raise AssertionError(f"ops_api: composed loss {float(loss)} vs "
                             f"loss_fn's {want} (rel {rel:.3g})")
    (g,) = paddle.grad([loss], [lf])
    with torch.no_grad():
        lab = labels._t.long()
        valid = (lab != -100)
        ref = torch.softmax(lf._t, -1)
        ref.scatter_add_(-1, torch.where(valid, lab, 0)[..., None],
                         -torch.ones_like(ref[..., :1]))
        ref *= valid[..., None] / valid.sum()
        err = float((g._t - ref).abs().max())
        ok = bool(torch.allclose(g._t, ref, **OPS_GRAD_TOL))
        del ref
    rec["grad"] = {"max_abs_err": err, "tol": OPS_GRAD_TOL}
    if not ok:
        raise AssertionError(f"ops_api: grad of the composed loss vs "
                             f"(softmax - one-hot)/count: max abs err {err}")
    del g, lf, loss
    last = logits[:, -1]
    picks = paddle.argmax(last, axis=-1).numpy().tolist()
    want_picks, margins = picks_and_margins(last._t.float())
    greedy = []
    for b, (p, w, m) in enumerate(zip(picks, want_picks, margins)):
        row = last._t[b].float()
        top = float(row.max())
        first_max = int(torch.nonzero(row == top)[0])
        # a bf16 tie at the top: argmax takes the first of the tied
        if p != (w if m > 0 else first_max):
            raise AssertionError(f"ops_api row {b}: argmax {p} vs the "
                                 f"forward's pick {w} (margin {m})")
        greedy.append({"row": b, "argmax": p, "pick": w, "margin": m,
                       "result": "match" if p == w else "tie"})
    rec["greedy"] = greedy
    tokens = top_p_draws(paddle, last, OPS_SEED)
    again = top_p_draws(paddle, last, OPS_SEED)
    if not paddle.equal_all(tokens, again).item():
        raise AssertionError("ops_api: one seed drew two token streams")
    # the top-p set by value, from torch alone: a token is in if its logit
    # reaches the last one that the sorted top-k's mass needs to pass p
    with torch.no_grad():
        srt = torch.sort(last._t.float(), -1, descending=True).values
        p = torch.softmax(srt[:, :OPS_TOP_K], -1)
        need = ((p.cumsum(-1) - p) < OPS_TOP_P).sum(-1)
        floor = srt.gather(-1, (need - 1)[:, None])
        got = last._t.float().gather(-1, tokens._t)
        inside = bool((got >= floor).all())
    rec["sampling"] = {"top_k": OPS_TOP_K, "top_p": OPS_TOP_P,
                       "draws": OPS_DRAWS, "top_p_set_sizes": need.tolist(),
                       "distinct_tokens": [len(set(r)) for r in
                                           tokens.numpy().tolist()],
                       "inside_top_p": inside, "repeat": True}
    if not inside:
        raise AssertionError("ops_api: a sampled token lies outside its "
                             "row's top-p set")
    torch.cuda.synchronize()
    rec["llama_s"] = time.perf_counter() - t
    launches = K.launches()
    if any(launches.values()):
        raise AssertionError(f"ops_api: the ops launched kernels {launches}")
    no_composed("ops_api")
    rec["launches"] = launches
    rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["nvidia_smi"] = smi
    torch.cuda.empty_cache()
    return rec


# Phase 8e: nn at BERT-base width (the repo's `bert_base` preset)
NN_VOCAB, NN_D, NN_HEADS, NN_FFN, NN_LAYERS = 30522, 768, 12, 3072, 12
NN_BATCH, NN_SEQ, NN_LABELED, NN_SEED = 16, 512, 0.15, 4321
NN_SOFTMAX_TOL = 1e-5   # f32 softmax rows of 128256 terms: sum within 1e-5


def nn_cases():
    """`tests/torch_nn_cases.py`, the nn CPU twins' table (numpy only)."""
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    import torch_nn_cases
    return torch_nn_cases


def nn_stack(paddle, dtype, depth=NN_LAYERS):
    """`paddle.seed(0)`, then `nn.Embedding`, a `depth`-layer post-LN
    `nn.TransformerEncoder` (gelu, no dropout) and an `nn.Linear` head at
    BERT-base width, in `dtype`."""
    nn = paddle.nn
    paddle.seed(0)
    layers = [nn.Embedding(NN_VOCAB, NN_D),
              nn.TransformerEncoder(nn.TransformerEncoderLayer(
                  NN_D, NN_HEADS, NN_FFN, dropout=0.0, activation="gelu"),
                  depth),
              nn.Linear(NN_D, NN_VOCAB)]
    for lyr in layers:
        lyr.astype(dtype)
    return layers


def nn_batch(paddle):
    """Seeded ids [B, S] and MLM labels: a random id at NN_LABELED of the
    positions, -100 (ignored) at the rest."""
    rng = np.random.RandomState(NN_SEED)
    ids = rng.randint(0, NN_VOCAB, (NN_BATCH, NN_SEQ))
    labels = np.where(rng.rand(NN_BATCH, NN_SEQ) < NN_LABELED,
                      rng.randint(0, NN_VOCAB, (NN_BATCH, NN_SEQ)), -100)
    return paddle.to_tensor(ids), paddle.to_tensor(labels)


def nn_pass(paddle, layers, ids, labels, mask=None):
    """Forward, `F.cross_entropy` (ignore_index -100) and `backward()`:
    (logits, loss)."""
    emb, enc, head = layers
    logits = head(enc(emb(ids), mask))
    loss = paddle.nn.functional.cross_entropy(logits, labels,
                                              ignore_index=-100)
    loss.backward()
    return logits, loss


def version_check_cost(paddle, layers, ids, labels, rounds=3):
    """The in-place version check's cost on (b)'s pass: the `apply` calls
    a pass makes (each records its inputs' versions and hangs a prehook on
    its outputs' grad node), then the pass timed with the check and with
    it replaced by a no-op, alternating.  These launches are not counted:
    (b) read its counts before."""
    import torch
    from paddle_tpu_torch.core import tensor as core_tensor
    check, calls = core_tensor._version_check, []

    def counted(*args):
        calls.append(args[0])
        check(*args)

    def timed(fn):
        core_tensor._version_check = fn
        for lyr in layers:
            lyr.clear_gradients()
        torch.cuda.synchronize()
        s = time.perf_counter()
        nn_pass(paddle, layers, ids, labels)
        torch.cuda.synchronize()
        return time.perf_counter() - s

    times = {"checked": [], "unchecked": []}
    try:
        timed(counted)
        for _ in range(rounds):
            times["checked"].append(timed(check))
            times["unchecked"].append(timed(lambda *args: None))
    finally:
        core_tensor._version_check = check
    for lyr in layers:
        lyr.clear_gradients()
    return {"apply_calls_a_pass": len(calls), "pass_s": times,
            "median_s": {k: sorted(v)[len(v) // 2] for k, v in times.items()}}


def nn_api(dev, smi, kept):
    """Phase 8e (see the module docstring): the nn twin table on the card,
    the BERT-base stack through the kernels in bf16, the kernel route
    against the plain route in f32, and the losses over 8c's logits."""
    import torch
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.incubate import kernels as K
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    place = f"gpu:{dev.index or 0}"
    # (a) every nn twin case on the card against the port on the CPU
    C = nn_cases()
    port_on_device = op_cases().port_on_device
    K.reset_launches()
    worst = {name: 0.0 for name in C.TABLES}
    for name, table in C.TABLES.items():
        for case in table:
            worst[name] = max(worst[name],
                              port_on_device(paddle, case, place))
    paddle.set_device(place)
    for name, fn in C.RANDOM.items():
        a, b, c = C.seeded_repeats(paddle, fn)
        if not np.array_equal(a, b) or np.array_equal(a, c):
            raise AssertionError(f"nn_api: {name} does not repeat under one "
                                 f"seed on the card")
    rec = {"table": {"cases": {n: len(t) for n, t in C.TABLES.items()},
                     "max_abs_diff_vs_cpu": worst,
                     "random_repeat": sorted(C.RANDOM)},
           "table_s": time.perf_counter() - t0}
    # (b) the stack at BERT-base width, bf16, through the kernels
    t = time.perf_counter()
    layers = nn_stack(paddle, "bfloat16")
    params = [p for lyr in layers for p in lyr.parameters()]
    ids, labels = nn_batch(paddle)
    torch.cuda.synchronize()
    K.reset_launches()
    t1 = time.perf_counter()
    logits, loss = nn_pass(paddle, layers, ids, labels)
    torch.cuda.synchronize()
    rec["bf16_pass_s"] = time.perf_counter() - t1
    launches = K.launches()
    no_composed("nn_api")
    want = {k: NN_LAYERS if k in ("flash_attention_fwd", "flash_bwd_dkv",
                                  "flash_bwd_dq") else 0 for k in launches}
    if launches != want:
        raise AssertionError(f"nn_api launches {launches}, want {want}")
    missing = [i for i, p in enumerate(params) if p.grad is None]
    if not math.isfinite(float(loss)) or missing:
        raise AssertionError(f"nn_api: loss {float(loss)}, parameters "
                             f"without grad {missing}")
    rec.update({"model": "bert_base width: Embedding + TransformerEncoder + "
                "Linear", "layers": NN_LAYERS, "dtype": "bf16",
                "batch": [NN_BATCH, NN_SEQ],
                "labeled": int((labels._t != -100).sum()),
                "parameters": sum(p.size for p in params),
                "logits": logits.shape, "loss": float(loss),
                "launches": launches,
                "bf16_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                "bf16_s": time.perf_counter() - t})
    del logits, loss
    rec["version_check"] = version_check_cost(paddle, layers, ids, labels)
    del layers, params
    torch.cuda.empty_cache()
    # (c) f32, TF32 off: the kernels against the plain route (an all-true
    # bool mask), logits, loss and every grad within BWD_F32_REL
    t = time.perf_counter()
    layers = nn_stack(paddle, "float32")
    params = [(n, p) for lyr in layers for n, p in lyr.named_parameters()]
    runs = []
    for mask in (None, paddle.to_tensor(torch.ones(
            1, 1, NN_SEQ, NN_SEQ, dtype=torch.bool, device=dev))):
        K.reset_launches()
        logits, loss = nn_pass(paddle, layers, ids, labels, mask)
        routed = K.composed_calls()["flash_attention_fused"]
        runs.append((logits._t.detach(), float(loss),
                     [p.grad._t.clone() for _, p in params], routed))
        for lyr in layers:
            lyr.clear_gradients()
        del logits, loss
    (lk, sk, gk, rk), (lp, sp, gp, rp) = runs
    if rk != 0 or rp != NN_LAYERS:
        raise AssertionError(f"nn_api f32: composed calls {rk} (kernels) "
                             f"and {rp} (mask), want 0 and {NN_LAYERS}")
    worst_f32, bad = {}, []
    for name, got, ref in [("logits", lk, lp),
                           ("loss", torch.tensor(sk), torch.tensor(sp))] + \
            [(n, g, r) for (n, _), g, r in zip(params, gk, gp)]:
        err = float((got - ref).abs().max())
        lim = BWD_F32_REL * max(1.0, float(ref.abs().max()))
        worst_f32[name] = err
        if err > lim:
            bad.append((name, err, lim))
    if bad:
        raise AssertionError(f"nn_api f32: kernel route vs plain route {bad}")
    top = max(worst_f32, key=worst_f32.get)
    rec["f32_vs_plain"] = {"tol": "BWD_F32_REL * max(1, max|ref|)",
                           "bwd_f32_rel": BWD_F32_REL, "composed_calls": rp,
                           "loss": [sk, sp], "max_abs_diff": worst_f32[top],
                           "at": top, "logits_max_abs_diff":
                           worst_f32["logits"], "tensors": len(worst_f32)}
    rec["f32_s"] = time.perf_counter() - t
    del layers, params, runs, lk, lp, gk, gp
    torch.cuda.empty_cache()
    # (d) F.cross_entropy and F.softmax over 8c's logits
    t = time.perf_counter()
    F = paddle.nn.functional
    ce = float(F.cross_entropy(kept["logits"], kept["labels"]))
    want_loss = float(kept["loss"])
    rel = abs(ce - want_loss) / abs(want_loss)
    sums = paddle.sum(F.softmax(kept["logits"], dtype="float32"), axis=-1)
    sum_err = float((sums._t - 1.0).abs().max())
    del sums
    rec["llama_logits"] = {"shape": kept["logits"].shape,
                           "cross_entropy": ce, "loss_fn": want_loss,
                           "rel_err": rel, "tol": OPS_LOSS_REL,
                           "softmax_row_sum_max_err": sum_err,
                           "softmax_tol": NN_SOFTMAX_TOL,
                           "s": time.perf_counter() - t}
    if rel > OPS_LOSS_REL or sum_err > NN_SOFTMAX_TOL:
        raise AssertionError(f"nn_api: cross_entropy {ce} vs loss_fn "
                             f"{want_loss} (rel {rel:.3g}), softmax rows "
                             f"off 1 by {sum_err}")
    torch.cuda.synchronize()
    rec["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    rec["nvidia_smi"] = smi
    torch.cuda.empty_cache()
    return rec


# Phase 8f: a BERT-base fine-tune through `paddle.optimizer`, one AdamW step
# against the CPU, and the conv, RNN and MoE Layers at working widths
NN_TRAIN_STEPS = 6
NN_TRAIN_F32_LAYERS = 2
OPT_F32_REL = 1e-6      # one f32 AdamW step, card vs CPU: <= 1e-6 * max(1, max|ref|)
RESNET_BATCH, RESNET_SIDE = 32, 224
LSTM_WIDTH, LSTM_BATCH, LSTM_STEPS = 1024, 32, 64
MOE_WIDTH, MOE_EXPERTS, MOE_TOKENS = 2048, 8, 8192
FLASH_ROWS = ("flash_attention_fwd", "flash_bwd_dkv", "flash_bwd_dq")


def nn_schedule(paddle):
    """Two warmup steps from 0 to 1e-3, then cosine over NN_TRAIN_STEPS."""
    lr = paddle.optimizer.lr
    return lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, T_max=NN_TRAIN_STEPS),
                           warmup_steps=2, start_lr=0.0, end_lr=1e-3)


def nn_adamw(paddle, params, sched):
    return paddle.optimizer.AdamW(
        learning_rate=sched, parameters=params, weight_decay=0.01,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))


def nn_fine_tune(paddle, dev):
    """8f (b): NN_TRAIN_STEPS AdamW steps of 8e's bf16 stack on 8e's batch,
    each pass counted alone; `opt.step()` under the sync debug mode
    "error" (a host read raises) and between CUDA events."""
    import torch
    from paddle_tpu_torch.incubate import kernels as K
    torch.cuda.reset_peak_memory_stats()
    layers = nn_stack(paddle, "bfloat16")
    params = [p for lyr in layers for p in lyr.parameters()]
    ids, labels = nn_batch(paddle)
    sched = nn_schedule(paddle)
    opt = nn_adamw(paddle, params, sched)
    twin = nn_schedule(paddle)
    want_lrs = []
    for _ in range(NN_TRAIN_STEPS):
        want_lrs.append(twin())
        twin.step()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    losses, lrs, step_ms, opt_ms, total = [], [], [], [], {}
    for step in range(NN_TRAIN_STEPS):
        torch.cuda.synchronize()
        K.reset_launches()
        t = time.perf_counter()
        _, loss = nn_pass(paddle, layers, ids, labels)
        lrs.append(opt.get_lr())
        ev[0].record()
        torch.cuda.set_sync_debug_mode("error")
        try:
            opt.step()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ev[1].record()
        opt.clear_grad()
        sched.step()
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        opt_ms.append(ev[0].elapsed_time(ev[1]))
        no_composed("nn_train")
        launches = K.launches()
        want = {k: NN_LAYERS if k in FLASH_ROWS else 0 for k in launches}
        if launches != want:
            raise AssertionError(f"nn_train step {step}: launches "
                                 f"{launches}, want {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        del loss
    if lrs != want_lrs:
        raise AssertionError(f"nn_train: learning rates {lrs}, the "
                             f"scheduler's {want_lrs}")
    accs = [opt._accumulators[name][id(p)] for name in ("moment1", "moment2")
            for p in params]
    bad = [i for i, a in enumerate(accs) if a.dtype != torch.float32 or
           a.device.type != dev.type]
    if bad or not all(math.isfinite(v) for v in losses) or \
            sum(losses[-2:]) / 2 >= losses[0]:
        raise AssertionError(f"nn_train: losses {losses}, moments off the "
                             f"card or not float32 {bad}")
    acc_bytes = sum(a.numel() * a.element_size()
                    for store in opt._accumulators.values()
                    for a in store.values())
    med = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    med_opt = sorted(opt_ms[1:])[len(opt_ms[1:]) // 2]
    rec = {"optimizer": "AdamW(weight_decay=0.01, ClipGradByGlobalNorm(1.0))",
           "schedule": "LinearWarmup(CosineAnnealingDecay(1e-3, T_max="
                       f"{NN_TRAIN_STEPS}), 2, 0.0, 1e-3)",
           "steps": NN_TRAIN_STEPS, "losses": losses, "lrs": lrs,
           "step_ms": step_ms, "median_step_ms_2_6": med,
           "opt_device_ms": opt_ms, "median_opt_device_ms_2_6": med_opt,
           "opt_share_of_step": med_opt / med,
           "host_syncs_in_opt_step": 0, "launches": total,
           "launches_per_step": {k: NN_LAYERS for k in FLASH_ROWS},
           "parameters": sum(p.size for p in params),
           "accumulator_bytes": acc_bytes,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}
    del layers, params, opt, accs
    torch.cuda.empty_cache()
    return rec


def nn_opt_f32(paddle, place):
    """8f (c): an NN_TRAIN_F32_LAYERS-layer f32 stack (TF32 off), one pass
    on the card; its parameters and grads copied to the port on the CPU;
    one AdamW step (the clip, the schedule one step in: lr 5e-4) on each
    device; every parameter, moment1 and moment2 within OPT_F32_REL."""
    import torch
    t = time.perf_counter()
    runs = []
    card = nn_stack(paddle, "float32", NN_TRAIN_F32_LAYERS)
    ids, labels = nn_batch(paddle)
    _, loss = nn_pass(paddle, card, ids, labels)
    card_params = [p for lyr in card for p in lyr.parameters()]
    paddle.set_device("cpu")
    try:
        host = nn_stack(paddle, "float32", NN_TRAIN_F32_LAYERS)
        host_params = [p for lyr in host for p in lyr.parameters()]
        for hp, cp in zip(host_params, card_params):
            hp.set_value(cp._t.detach().cpu())
            hp.grad = paddle.to_tensor(cp.grad._t.cpu())
        for params in (card_params, host_params):
            sched = nn_schedule(paddle)
            sched.step()
            opt = nn_adamw(paddle, params, sched)
            opt.step()
            runs.append([(p.name, p._t.detach(),
                          opt._accumulators["moment1"][id(p)],
                          opt._accumulators["moment2"][id(p)])
                         for p in params])
    finally:
        paddle.set_device(place)
    worst, bad = {"param": 0.0, "moment1": 0.0, "moment2": 0.0}, []
    for (name, *got), (_, *want) in zip(*runs):
        for kind, g, w in zip(("param", "moment1", "moment2"), got, want):
            err = float((g.cpu() - w).abs().max())
            lim = OPT_F32_REL * max(1.0, float(w.abs().max()))
            worst[kind] = max(worst[kind], err)
            if err > lim:
                bad.append((name, kind, err, lim))
    if bad:
        raise AssertionError(f"nn_train f32 AdamW step, card vs CPU: {bad}")
    rec = {"layers": NN_TRAIN_F32_LAYERS, "loss": float(loss), "lr": 5e-4,
           "tol": "OPT_F32_REL * max(1, max|cpu|)", "opt_f32_rel": OPT_F32_REL,
           "tensors": 3 * len(card_params), "max_abs_diff": worst,
           "s": time.perf_counter() - t}
    del card, host, runs, card_params, host_params, loss
    torch.cuda.empty_cache()
    return rec


def resnet_stage1(paddle):
    """ResNet-50's stem and stage 1: 7x7/2 conv to 64, BN, ReLU, 3x3/2 max
    pool, three 64-64-256 bottlenecks (the first with a projection), a
    global average pool."""
    nn = paddle.nn

    def conv_bn(cin, cout, k, stride=1):
        return nn.Sequential(nn.Conv2D(cin, cout, k, stride, k // 2,
                                       bias_attr=False), nn.BatchNorm2D(cout))

    class Bottleneck(nn.Layer):
        def __init__(self, cin):
            super().__init__()
            self.body = nn.Sequential(conv_bn(cin, 64, 1), nn.ReLU(),
                                      conv_bn(64, 64, 3), nn.ReLU(),
                                      conv_bn(64, 256, 1))
            self.short = conv_bn(cin, 256, 1) if cin != 256 else None
            self.relu = nn.ReLU()

        def forward(self, x):
            skip = x if self.short is None else self.short(x)
            return self.relu(self.body(x) + skip)

    return nn.Sequential(nn.Conv2D(3, 64, 7, 2, 3, bias_attr=False),
                         nn.BatchNorm2D(64), nn.ReLU(), nn.MaxPool2D(3, 2, 1),
                         Bottleneck(64), Bottleneck(256), Bottleneck(256),
                         nn.AdaptiveAvgPool2D(1))


def working_layer(paddle, name, layer, run):
    """8f (d): one bf16 forward, backward and `Momentum` step of `layer`:
    a finite loss, a grad on every parameter, no kernel launch of the
    port's and no composed call."""
    import torch
    from paddle_tpu_torch.incubate import kernels as K
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t = time.perf_counter()
    layer.astype("bfloat16")
    params = list(layer.parameters())
    opt = paddle.optimizer.Momentum(0.01, 0.9, parameters=params)
    loss, extra = run(layer)
    loss.backward()
    missing = [n for n, p in layer.named_parameters() if p.grad is None]
    opt.step()
    opt.clear_grad()
    value = float(loss)
    torch.cuda.synchronize()
    no_composed(f"nn_train {name}")
    launched = {k: v for k, v in K.launches().items() if v}
    if missing or launched or not math.isfinite(value):
        raise AssertionError(f"nn_train {name}: loss {value}, no grad on "
                             f"{missing}, launches {launched}")
    return {"loss": value, "parameters": sum(p.size for p in params),
            "s": time.perf_counter() - t,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
            **extra}


def nn_working_widths(paddle, dev):
    """8f (d): ResNet-50's stem and stage 1 on B 32 x 3 x 224 x 224, a
    2-layer LSTM(1024) on B 32 x T 64, and a gshard top-2 MoELayer of 8
    Linear(2048) experts on 8192 tokens, each in bf16."""
    import torch
    from paddle_tpu_torch.incubate.distributed.models import moe
    g = torch.Generator(device=dev).manual_seed(7)

    def rand(*shape):
        return paddle.to_tensor(torch.randn(*shape, generator=g, device=dev,
                                            dtype=torch.bfloat16))

    def resnet(layer):
        out = layer(rand(RESNET_BATCH, 3, RESNET_SIDE, RESNET_SIDE))
        return out.astype("float32").mean(), {"out": out.shape}

    def lstm(layer):
        zeros = paddle.to_tensor(torch.zeros(
            2, LSTM_BATCH, LSTM_WIDTH, dtype=torch.bfloat16, device=dev))
        out, (h, c) = layer(rand(LSTM_BATCH, LSTM_STEPS, LSTM_WIDTH),
                            (zeros, zeros))
        return out.astype("float32").mean(), {"out": out.shape,
                                              "h": h.shape}

    def moe_run(layer):
        x = rand(MOE_TOKENS, MOE_WIDTH)
        out = layer(x)
        aux = layer.gate.get_loss()
        C = max(int(layer.capacity_factor * MOE_TOKENS * layer.gate.topk /
                    MOE_EXPERTS), 4)
        with torch.no_grad():
            idx, _ = layer.gate(x)
            layer.gate.get_loss()
            _, keep = moe.dispatch.capacity_slots(idx._t, MOE_EXPERTS, C)
        return out.astype("float32").mean() + 0.01 * aux, {
            "capacity": C, "assignments": int(keep.numel()),
            "dropped": int((~keep).sum()), "aux": float(aux)}

    nn = paddle.nn
    paddle.seed(0)
    builds = (("resnet50_stage1", lambda: resnet_stage1(paddle), resnet),
              ("lstm", lambda: nn.LSTM(LSTM_WIDTH, LSTM_WIDTH, num_layers=2),
               lstm),
              ("moe", lambda: moe.MoELayer(
                  d_model=MOE_WIDTH,
                  experts=[nn.Linear(MOE_WIDTH, MOE_WIDTH)
                           for _ in range(MOE_EXPERTS)],
                  gate="gshard", topk=2), moe_run))
    rec = {}
    for name, build, run in builds:
        rec[name] = working_layer(paddle, name, build(), run)
        torch.cuda.empty_cache()
    return rec


def nn_train(dev, smi):
    """Phase 8f (see the module docstring)."""
    import torch
    import paddle_tpu_torch as paddle
    t0 = time.perf_counter()
    place = f"gpu:{dev.index or 0}"
    paddle.set_device(place)
    rec = nn_fine_tune(paddle, dev)
    rec["fine_tune_s"] = time.perf_counter() - t0
    rec["f32_step_vs_cpu"] = nn_opt_f32(paddle, place)
    rec["working_widths"] = nn_working_widths(paddle, dev)
    torch.cuda.synchronize()
    rec["nvidia_smi"] = smi
    return rec


def moe_config():
    """`gpt3_1p3b` with `gpt_moe_tiny`'s expert knobs: an expert layer of 4
    experts (top-2, capacity factor 2) in every block, bf16."""
    import torch
    from paddle_tpu_torch.models import gpt
    cfg = gpt.gpt3_1p3b()
    cfg.moe_num_experts, cfg.moe_topk, cfg.moe_capacity_factor = 4, 2, 2.0
    cfg.dtype = torch.bfloat16
    return cfg


def moe_drops(params, cfg, rows):
    """Dropped assignments (`keep` false) of every MoE layer in one eager
    forward over `rows` [B, S]: (dropped, assignments)."""
    import torch
    from paddle_tpu_torch.incubate.distributed.models.moe import dispatch
    from paddle_tpu_torch.models import gpt
    seen, slots = [], dispatch.capacity_slots

    def spy(*args):
        slot, keep = slots(*args)
        seen.append(keep)
        return slot, keep

    dispatch.capacity_slots = spy
    try:
        with torch.no_grad():
            gpt.forward(params, rows, cfg)
    finally:
        dispatch.capacity_slots = slots
    return (int(sum(int((~k).sum()) for k in seen)),
            int(sum(k.numel() for k in seen)))


def fused_replay_vs_eager(params, cfg, dev):
    """One replay of a warmed MoE engine's fused step against its eager
    body on identical staged inputs and an identical random pool: tokens
    and pool pages 1 and up bitwise equal.  Slots decode at the smoke
    prompts' lengths over random pages."""
    import torch
    from paddle_tpu_torch.inference.engine import LLMEngine
    eng = LLMEngine(params, cfg, num_slots=8, page_size=16,
                    max_model_len=2048, prefill_buckets=SERVE_BUCKETS,
                    device=dev)
    eng.warm_decode()
    prog = eng._programs["fused"]
    gen = torch.Generator(device=dev).manual_seed(5)
    for t in eng._pool.values():
        t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.5)
    pool = {n: t.clone() for n, t in eng._pool.items()}
    rng = np.random.RandomState(5)
    P, page = eng.cache.max_pages_per_slot, eng.cache.page_size
    pages = list(rng.permutation(np.arange(1, eng.cache.num_pages)))
    table = np.zeros((8, P), np.int32)
    for b, n in enumerate(PROMPT_LENS):
        k = n // page + 1
        table[b, :k] = [pages.pop() for _ in range(k)]
    feed = dict(tokens=rng.randint(0, cfg.vocab_size, (8, 1)), table=table,
                q_offset=np.array(PROMPT_LENS), valid=np.ones(8, np.int32),
                greedy=np.ones(8, bool))
    runs = []
    for eager in (False, True):
        for n in pool:
            eng._pool[n].copy_(pool[n])
        prog.stage(**feed)
        if eager:
            out = prog._body(**prog.inputs).cpu().numpy()
        else:
            prog.run()
            out = prog.result()
        torch.cuda.synchronize()
        runs.append((out, {n: t[:, 1:].clone() for n, t in
                           eng._pool.items()}))
    (g_out, g_pool), (e_out, e_pool) = runs
    same = bool(np.array_equal(g_out, e_out)) and all(
        torch.equal(g_pool[n], e_pool[n]) for n in g_pool)
    if not same:
        raise AssertionError("engine_moe: the fused step's replay differs "
                             "from its eager body")
    del eng, runs, pool
    return {"slots": 8, "q_offset": list(PROMPT_LENS), "bitwise": same}


def engine_moe(dev):
    """Phase 13 (see the module docstring)."""
    import gc

    import torch
    from paddle_tpu_torch.models import gpt
    cfg = moe_config()
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    outs, rec = serve(params, cfg, prompts, None, dev)
    picks = forward_picks(params, cfg, dict(enumerate(prompts)))
    rec["first_token"] = check_first_tokens(picks, outs, "engine_moe")
    rec["replay_vs_eager"] = fused_replay_vs_eager(params, cfg, dev)
    outs8, rec8 = serve(params, cfg, prompts, None, dev, int8=True)
    dense = dequantized_params(params, cfg)
    rec8["first_token"] = check_first_tokens(
        forward_picks(dense, cfg, dict(enumerate(prompts))), outs8,
        "engine_moe int8")
    del dense
    rec8["greedy_agreement_with_bf16"] = agreement(outs, outs8)
    step = torch.from_numpy(np.stack([p[-1:] for p in prompts])).to(dev)
    dropped, assigned = moe_drops(params, cfg, step)
    pre_dropped, pre_assigned = moe_drops(
        params, cfg, torch.from_numpy(prompts[5][None]).to(dev))
    out = {"model": "gpt3_1p3b_moe", "layers": cfg.num_layers,
           "experts": cfg.moe_num_experts, "topk": cfg.moe_topk,
           "capacity_factor": cfg.moe_capacity_factor, "dtype": "bf16",
           "params": gpt.count_params(params), **rec, "int8": rec8,
           "dropped_one_decode_step": [dropped, assigned],
           "dropped_one_prefill_512": [pre_dropped, pre_assigned]}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_moe(dev):
    """Phase 14: the MoE config through the trainer, bf16 params and
    moments, remat, B=4, S=2048: 1 warm-up + 4 timed steps."""
    import gc

    import torch
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import HybridParallelTrainer, MeshConfig
    cfg = moe_config()
    B, S, steps = 4, 2048, 4
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = HybridParallelTrainer(cfg, MeshConfig(remat=True),
                                    moment_dtype=torch.bfloat16, device=dev)
    rng = np.random.RandomState(0)
    tok = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1).astype(np.int32)
    torch.cuda.synchronize()
    K.reset_launches()
    losses = [float(trainer.train_step(tok, lab))]          # warm-up
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(tok, lab)))  # syncs
        times.append(time.perf_counter() - t0)
    launches = K.launches()
    no_composed("train_moe")
    with torch.no_grad():
        _, _, aux = gpt.backbone(trainer.params, tok, cfg)
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train_moe: losses {losses}")
    want = cfg.num_layers * (steps + 1)
    for name in ("flash_attention_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        if launches[name] != want:
            raise AssertionError(f"train_moe: {name} launched "
                                 f"{launches[name]} times, want {want}")
    rec = {"model": "gpt3_1p3b_moe", "layers": cfg.num_layers,
           "dtype": "bf16", "moments": "bf16", "remat": True,
           "batch": [B, S], "params": gpt.count_params(trainer.params),
           "aux": float(aux), "tokens_per_s": B * S * steps / sum(times),
           "mean_step_ms": 1e3 * sum(times) / steps,
           "median_step_ms": 1e3 * float(np.median(times)),
           "peak_mem_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "losses": losses, "launches": launches}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phase 15: BERT-base through the non-causal kernel lanes
# ---------------------------------------------------------------------------

BERT_SHAPE = (16, 512, 12, 64)


def mlm_batch(cfg, B, S, seed=0):
    """Tokens, two segments a row and MLM labels on 15% of the positions
    (-100 elsewhere)."""
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    lab = np.where(rng.rand(B, S) < 0.15, tok, -100).astype(np.int32)
    return tok, lab


def bert(dev):
    """Phase 15 (see the module docstring)."""
    import gc

    import torch
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.incubate.kernels.flash_attention import \
        attention_ref
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import HybridParallelTrainer, MeshConfig
    from paddle_tpu_torch.parallel.hybrid import _leaves
    cfg = gpt.bert_base()
    cfg.dtype = torch.bfloat16
    B, S, steps = 16, 512, 4
    trainer = HybridParallelTrainer(cfg, MeshConfig(), learning_rate=1e-3,
                                    moment_dtype=torch.bfloat16, device=dev)
    tok, lab = mlm_batch(cfg, B, S)
    torch.cuda.synchronize()
    K.reset_launches()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(tok, lab)))
        times.append(time.perf_counter() - t0)
    launches = K.launches()
    no_composed("bert")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"bert: losses {losses}")
    want = cfg.num_layers * steps
    for name in ("flash_attention_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        if launches[name] != want:
            raise AssertionError(f"bert: {name} launched {launches[name]} "
                                 f"times, want {want}")
    rec = {"model": "bert_base", "layers": cfg.num_layers, "dtype": "bf16",
           "batch": [B, S], "params": gpt.count_params(trainer.params),
           "losses": losses, "tokens_per_s": B * S * (steps - 1) /
           sum(times[1:]), "median_step_ms": 1e3 * float(np.median(
               times[1:])), "launches": launches}
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    # float32, TF32 off: loss_fn and its grads through the kernels against
    # the same with plain attention
    cfg = gpt.bert_base()
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                             dev)
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_()
    tok, lab = mlm_batch(cfg, 4, S, seed=1)
    runs = []
    for impl in (None, lambda q, k, v: attention_ref(q, k, v, causal=False)):
        loss = gpt.loss_fn(params, tok, lab, cfg, attn_impl=impl)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        runs.append((loss.item(), grads))
        del loss
    no_composed("bert f32")
    (lk, gk), (lr, gr) = runs
    rel = abs(lk - lr) / abs(lr)
    worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for a, b in zip(gk, gr) if float(b.abs().max()) > 0)
    if not (math.isfinite(lk) and rel <= 1e-4 and worst <= 1e-3):
        raise AssertionError(f"bert parity: loss {lk} vs {lr} (rel "
                             f"{rel:.3g}), worst grad leaf {worst:.3g}")
    rec["parity_f32"] = {"batch": [4, S], "loss_kernels": lk,
                         "loss_plain": lr, "loss_rel_diff": rel,
                         "worst_grad_leaf_rel_err": worst}
    del params, leaves, runs, gk, gr
    gc.collect()
    torch.cuda.empty_cache()
    # the kernels at the encoder shape (rows 2, 5 and 6, non-causal D 64)
    rec["fwd"] = flash_case(torch.bfloat16, dev, BERT_SHAPE, causal=False)
    rec["bwd"] = bwd_case(torch.bfloat16, dev, BERT_SHAPE, False)
    torch.cuda.empty_cache()
    return rec


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


# ---------------------------------------------------------------------------
# train_mesh: data, ZeRO and tensor-parallel training
# ---------------------------------------------------------------------------

# (a): GPT-3 1.3B over dp 2 x mp 2 with sequence parallelism, ZeRO-1, on
# four gloo ranks of the one card; its depth cut to 8 (68.6 s at all 24:
# 9.5 s a step of host-staged gloo all-reduces) with phases 12d-12e in the
# smoke (PERF.md section 4)
TRAIN_MESH = dict(dp=2, mp=2, sharding_stage=1, sequence_parallel=True)
TRAIN_MESH_LAYERS = 8
TRAIN_MESH_BATCH = (4, 2048)
TRAIN_MESH_STEPS = 2            # timed, after one warm-up
# (b): float32 parity at GPT-3 1.3B width, 2 layers
PARITY_LAYOUTS = (
    ("mp1", {}),
    ("dp2_mp2_z1", dict(dp=2, mp=2, sharding_stage=1)),
    ("sh2_mp2_z3_sp", dict(sharding=2, mp=2, sharding_stage=3,
                           sequence_parallel=True)))
PARITY_BATCH, PARITY_STEPS, PARITY_TOL = (4, 1024), 3, 1e-4
# --tp: the same training on four cards under NCCL, against mp 1 on one
TRAIN_NCCL_LAYOUTS = (("dp4_z1", dict(dp=4, sharding_stage=1)),
                      ("mp4", dict(mp=4)),
                      ("dp2_mp2_sp", dict(dp=2, mp=2,
                                          sequence_parallel=True)))
# (b): cp over NCCL, against mp1 (one card)
TRAIN_NCCL_CP = (("cp4", dict(cp=4)), ("dp2_cp2", dict(dp=2, cp=2)))
FLASH_KERNELS = ("flash_attention_fwd", "flash_bwd_dkv", "flash_bwd_dq")


def train_batch(cfg, B, S, seed=0):
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1).astype(np.int32)


def mesh_train_run(trainer, tok, lab, steps, what, per_step=None):
    """One warm-up and `steps` timed steps, every rank's kernel counts and
    collective stats zeroed just before the warm-up and read just after
    the last step: the losses, step times, and per rank the launches
    (rows 2, 5 and 6 exactly `per_step` (default: layers; a list: rank
    r's) x steps, nothing composed), the peak device bytes and the
    collectives a step (calls and bytes)."""
    import torch
    from paddle_tpu_torch.incubate import kernels as K
    mesh = trainer.mesh
    torch.cuda.synchronize()
    if mesh is None:
        K.reset_launches()
        torch.cuda.reset_peak_memory_stats(trainer.device)
    else:
        mesh.reset_counts()
        trainer.reset_rank_stats()
    losses = [float(trainer.train_step(tok, lab))]      # warm-up
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(float(trainer.train_step(tok, lab)))  # waits all ranks
        times.append(time.perf_counter() - t0)
    n = steps + 1
    if mesh is None:
        counts = [{"launches": K.launches(),
                   "composed_calls": K.composed_calls()}]
        stats = [{"comm": {}, "peak_mem": torch.cuda.max_memory_allocated(
                      trainer.device)}]
    else:
        counts, stats = mesh.rank_counts(), trainer.rank_stats()
    per = per_step or trainer.config.num_layers
    for r, c in enumerate(counts):
        want = (per[r] if isinstance(per, list) else per) * n
        if any(c["composed_calls"].values()):
            raise AssertionError(f"{what} rank {r}: composed routes "
                                 f"{c['composed_calls']}")
        got = [c["launches"][k] for k in FLASH_KERNELS]
        if got != [want] * len(FLASH_KERNELS):
            raise AssertionError(f"{what} rank {r}: rows 2, 5, 6 launched "
                                 f"{got}, want {want} each")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{what}: non-finite loss {losses}")
    B, S = tok.shape
    return {
        "losses": losses, "tokens_per_s": B * S * steps / sum(times),
        "mean_step_ms": 1e3 * sum(times) / steps,
        "step_ms": [1e3 * t for t in times],
        "launches": [{k: c["launches"][k] for k in FLASH_KERNELS}
                     for c in counts],
        "launches_all": [c["launches"] for c in counts],
        "rank_peak_mem_gib": [s["peak_mem"] / 2 ** 30 for s in stats],
        "collectives_per_step": [
            {k: {"calls": v[0] / n, "bytes": v[1] / n}
             for k, v in sorted(s["comm"].items())} for s in stats]}


def train_parity_mesh(dev, mesh):
    """(b): float32 (TF32 off), GPT-3 1.3B width at 2 layers, B 4, S 1024,
    3 steps under each of PARITY_LAYOUTS from the same weights: losses and
    the gathered parameters after the steps within PARITY_TOL."""
    from paddle_tpu_torch.models import gpt
    cfg = gpt.gpt3_1p3b()
    cfg.num_layers = 2
    return mesh_parity(cfg, PARITY_LAYOUTS, PARITY_BATCH, dev, mesh,
                       "train_mesh parity")


def mesh_parity(cfg, layouts, batch, dev, mesh, what,
                loss_tol=PARITY_TOL):
    """PARITY_STEPS steps of `cfg` (float32) on one device ("mp1", first in
    `layouts`, a degree-1 MeshConfig) and under each mesh layout of
    `layouts` from the same weights (seed 1).  The losses: every step
    within `loss_tol` (default PARITY_TOL) relative of mp 1's.  The gathered parameters: every
    element within PARITY_TOL (rtol and atol), and for MoE every leaf too
    within PARITY_TOL in relative norm |a - b| / |b|; dense after the last
    step, MoE after each step while the router has chosen every token's
    experts as on one device (`train_step_routes` logs its choices).  Top-k
    routing is discontinuous: a near-tie that float rounding flips moves
    the elements the token's gradient reaches.  So from the first step
    whose choices differ (`route_flips`) the parameters are reported, not
    held, and that step must be a later one than the first, with every
    differing choice of its lowest such layer a near-tie (the chosen and
    the passed-over expert's probabilities within PARITY_TOL on one
    device).  Each run's seconds are kept."""
    import torch
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import HybridParallelTrainer, MeshConfig
    from paddle_tpu_torch.parallel.hybrid import _leaves, _map, _names
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                             dev)
    tok, lab = train_batch(cfg, *batch, seed=1)
    moe = cfg.moe_num_experts > 0
    names = _names(params)
    rec = {"model": "gpt3_1p3b", "layers": cfg.num_layers, "dtype": "float32",
           "experts": cfg.moe_num_experts, "batch": list(batch),
           "steps": PARITY_STEPS, "seconds": {}}
    base = None             # mp 1's losses, routes and parameters a step
    for name, kw in layouts:
        t = time.perf_counter()
        # one device updates the tree it is given in place: a copy
        mc = MeshConfig(**kw)
        tr = HybridParallelTrainer(cfg, mc, **(
            {"mesh": mesh, "params": params} if mc.size > 1 else
            {"device": dev, "params": _map(torch.clone, params)}))
        run = {"losses": [], "routes": [], "params": []}
        for s in range(PARITY_STEPS):
            if moe:
                loss, idx, probs = tr.train_step_routes(tok, lab)
                run["routes"].append((idx, probs))
            else:
                loss = tr.train_step(tok, lab)
            run["losses"].append(float(loss))
            if not (moe or s == PARITY_STEPS - 1):
                continue
            got = _leaves(tr.gathered_state(("params",))["params"])
            if base is None:
                run["params"].append(got)
            else:
                run["params"].append(leaf_diffs(got, base["params"][
                    len(run["params"])], names, dev))
            del got
        tr.close()
        del tr
        torch.cuda.empty_cache()
        rec["seconds"][name] = time.perf_counter() - t
        if base is None:
            base = run
            rec["losses_" + name] = run["losses"]
            continue
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(run["losses"], base["losses"]))
        out = {"losses": run["losses"], "loss_max_rel_diff": rel}
        held = run["params"]
        bad = []
        if moe:
            flips = route_flips(base["routes"], run["routes"])
            out["route_flips"] = flips
            first = next((f for f in flips["per_step"]
                          if f["set_differs"]), None)
            if first is not None:
                held = held[:first["step"]]
                out["params_reported_after_step"] = first["step"]
                if not held:
                    bad.append("routes differ at step 0")
                if not max(first["first_layer_margins"]) < PARITY_TOL:
                    bad.append(f"a flip at step {first['step']} is no "
                               f"near-tie: {first['first_layer_margins']}")
            out["params_by_step"] = run["params"]
        else:
            out.update(run["params"][-1])
        for s, d in enumerate(held):
            bad += [f"step {s if moe else PARITY_STEPS - 1} {n}: "
                    f"{d['elements_past_tol'].get(n, 0)} elements, norm "
                    f"{v:.3g}" for n, v in d["leaf_norm_rel_diff"].items()
                    if d["elements_past_tol"].get(n) or
                    (moe and not v <= PARITY_TOL)]
        rec[name] = out
        if not rel <= loss_tol or bad:
            raise AssertionError(f"{what} {name}: loss rel {rel:.3g}; "
                                 f"{bad}")
    return rec


def leaf_diffs(got, want, names, dev):
    """Leaf by leaf (on `dev`): each leaf's relative norm |a - b| / |b|,
    the elements past PARITY_TOL (rtol and atol) and over 1e-6, the
    largest difference and the whole tree's relative norm."""
    import torch
    out = {"leaf_norm_rel_diff": {}, "elements_past_tol": {},
           "elements_over_1e-6": 0, "param_max_abs_diff": 0.0}
    dd = ww = 0.0
    for n, a, b in zip(names, got, want):
        a, b = a.to(dev), b.to(dev)
        d = (a - b).double()
        d2, w2 = float(d.square().sum()), float(b.double().square().sum())
        dd, ww = dd + d2, ww + w2
        out["leaf_norm_rel_diff"][n] = math.sqrt(d2 / max(w2, 1e-300))
        past = int((~torch.isclose(a, b, rtol=PARITY_TOL,
                                   atol=PARITY_TOL)).sum())
        if past:
            out["elements_past_tol"][n] = past
        out["elements_over_1e-6"] += int((d.abs() > 1e-6).sum())
        m = float(d.abs().max())
        if m >= out["param_max_abs_diff"]:
            out["param_max_abs_diff"], out["worst_leaf"] = m, n
        del a, b, d
    out["param_norm_rel_diff"] = math.sqrt(dd / ww)
    out["worst_leaf_norm_rel_diff"] = max(
        out["leaf_norm_rel_diff"].values())
    return out


def route_flips(base, other):
    """Where two runs' logged routes (per step: gate_idx [L, T, k], probs
    [L, T, E]) part.  Per step: the (layer, token) count whose top-k set
    differs and whose order alone differs, the largest probability gap,
    and at the lowest layer whose sets differ the margins of `base` there
    (the gap between the probabilities of the expert it chose and the one
    `other` chose instead).  And the first 8 differences, with both runs'
    experts and probabilities."""
    import torch
    out = {"per_step": [], "first": []}
    for s, ((ia, pa), (ib, pb)) in enumerate(zip(base, other)):
        order = (ia != ib).any(-1)
        ia_s, ib_s = ia.sort(-1).values, ib.sort(-1).values
        set_diff = (ia_s != ib_s).any(-1)
        step = {"step": s, "set_differs": int(set_diff.sum()),
                "order_differs": int((order & ~set_diff).sum()),
                "probs_max_abs_diff": float((pa - pb).abs().max())}
        if step["set_differs"]:
            layer = int(torch.nonzero(set_diff.any(-1))[0])
            step["first_set_layer"] = layer
            margins = []
            for tok in torch.nonzero(set_diff[layer]).flatten().tolist():
                a, b = set(ia[layer, tok].tolist()), set(ib[layer, tok].tolist())
                p = pa[layer, tok]
                margins += [float(p[e] - p[f]) for e in a - b for f in b - a]
            step["first_layer_margins"] = margins
        out["per_step"].append(step)
        for layer, tok in torch.nonzero(order).tolist():
            if len(out["first"]) >= 8:
                break
            out["first"].append({
                "step": s, "layer": layer, "token": tok,
                "kind": "set" if set_diff[layer, tok] else "order",
                "experts_base": ia[layer, tok].tolist(),
                "experts_other": ib[layer, tok].tolist(),
                "probs_base": pa[layer, tok].tolist(),
                "probs_other": pb[layer, tok].tolist()})
    return out


def train_mesh(dev, smi):
    """Phase 12b (see the module docstring).  Returns (record, the summed
    launches of (a)'s ranks)."""
    import torch
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import HybridParallelTrainer, MeshConfig
    from paddle_tpu_torch.parallel.tp import serving_mesh
    t = time.perf_counter()
    cfg = gpt.gpt3_1p3b()
    cfg.dtype = torch.bfloat16
    cfg.num_layers = TRAIN_MESH_LAYERS
    tok, lab = train_batch(cfg, *TRAIN_MESH_BATCH)
    mesh = serving_mesh(4, [dev] * 4, backend="gloo")
    rec = {"nvidia_smi": smi, "ranks": 4, "backend": "gloo",
           "timing_note": "four ranks time-slicing one card, gloo "
           "collectives through host memory: not a data- or "
           "tensor-parallel time"}
    try:
        tr = HybridParallelTrainer(cfg, MeshConfig(**TRAIN_MESH, remat=True),
                                   moment_dtype=torch.bfloat16, mesh=mesh)
        run = mesh_train_run(tr, tok, lab, TRAIN_MESH_STEPS, "train_mesh")
        tr.close()
        del tr
        losses = run["losses"]
        if abs(losses[0] - math.log(cfg.vocab_size)) > 0.5:
            raise AssertionError(f"train_mesh: step-0 loss {losses[0]} is "
                                 f"not near ln(V)")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train_mesh: loss did not fall {losses}")
        rec["gpt3_1p3b"] = {"layers": cfg.num_layers, "dtype": "bf16",
                            "moments": "bf16", "remat": True,
                            "mesh": TRAIN_MESH, "batch":
                            list(TRAIN_MESH_BATCH), **run}
        rec["gpt3_1p3b_seconds"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        rec["parity_f32"] = train_parity_mesh(dev, mesh)
    finally:
        mesh.close()
    torch.cuda.empty_cache()
    # (c): rows 2, 5 and 6 at a rank's shape
    B, S = TRAIN_MESH_BATCH
    shape = (B // TRAIN_MESH["dp"], S, cfg.num_heads // TRAIN_MESH["mp"],
             cfg.head_dim)
    rec["kernels"] = [flash_case(torch.bfloat16, dev, shape),
                      bwd_case(torch.bfloat16, dev, shape, True)]
    summed = {k: sum(c[k] for c in run["launches_all"])
              for k in run["launches_all"][0]}
    return rec, summed


# ---------------------------------------------------------------------------
# train_pp: pipeline and expert-parallel training
# ---------------------------------------------------------------------------

# (a): GPT-3 1.3B under two pipeline layouts of four gloo ranks on the one
# card; the depth is cut to 8, since the phase passed 180 s at 24, then to
# 4 (one layer a stage at pp 4, one a chunk at pp 2 x vpp 2) when the
# smoke with phase 8c ran past 1000 s on a slower host (PERF.md section 4)
TRAIN_PP_LAYERS = 4
TRAIN_PP_BATCH = (8, 2048)
TRAIN_PP_LAYOUTS = (("pp4", dict(pp=4, micro_batches=8)),
                    ("pp2_vpp2_mp2", dict(pp=2, vpp=2, mp=2,
                                          micro_batches=4)))
TRAIN_PP_STEPS = 2              # timed, after one warm-up
# (b): the MoE config (`moe_config`) at pp 2 x ep 2; 3 timed steps: its
# loss rises at step 1 and falls below step 0's at step 3, as phase 14's
TRAIN_PP_MOE = dict(pp=2, ep=2, micro_batches=2)
TRAIN_PP_MOE_BATCH = (4, 2048)
TRAIN_PP_MOE_STEPS = 3
# (c): float32 parity at GPT-3 1.3B width, 4 layers; the MoE width with
# capacity factor 8 (no token drops) against pp 2 x ep 2
PP_PARITY_LAYERS, PP_PARITY_BATCH = 4, (8, 1024)
PP_PARITY_LAYOUTS = (("mp1", {}),
                     ("pp4", dict(pp=4, micro_batches=4)),
                     ("pp2_vpp2_mp2", dict(pp=2, vpp=2, mp=2,
                                           micro_batches=4)))
# remat: one device's f32 expert buffers at capacity 8 are 4 GiB a layer
PP_PARITY_MOE = (("mp1", dict(remat=True)),
                 ("pp2_ep2", dict(pp=2, ep=2, micro_batches=2, remat=True)))
# (d): rows 2, 5 and 6 at a stage's microbatch of (a)'s pp 4 (B 8 over 8
# microbatches)
PP_STAGE_SHAPE = (1, 2048, 16, 128)


def comm_subset(run, prefixes):
    """Per rank, the collectives a step whose group starts with one of
    `prefixes` (the pipeline's links, the ep all-to-all)."""
    return [{k: v for k, v in rank.items() if k.split(".")[0].startswith(
        prefixes)} for rank in run["collectives_per_step"]]


def pp_run(cfg, kw, batch, mesh, what, steps=TRAIN_PP_STEPS):
    """`mesh_train_run` of `cfg` (bf16, bf16 moments, remat) at
    MeshConfig(**kw), one warm-up and `steps` timed steps: rows 2, 5 and 6
    (layers a stage) x microbatches launches a step on every rank; the
    bubble share of the schedule."""
    import torch
    from paddle_tpu_torch.parallel import HybridParallelTrainer, MeshConfig
    from paddle_tpu_torch.parallel.pipeline import bubble_share
    mc = MeshConfig(**kw, remat=True)
    tok, lab = train_batch(cfg, *batch)
    tr = HybridParallelTrainer(cfg, mc, moment_dtype=torch.bfloat16,
                               mesh=mesh)
    run = mesh_train_run(tr, tok, lab, steps, what,
                         per_step=cfg.num_layers // mc.pp * mc.micro_batches)
    tr.close()
    del tr
    torch.cuda.empty_cache()
    if not run["losses"][-1] < run["losses"][0]:
        raise AssertionError(f"{what}: loss did not fall {run['losses']}")
    return {"mesh": kw, "batch": list(batch),
            "bubble_share": bubble_share(mc.pp, mc.vpp, mc.micro_batches),
            "p2p_per_step": comm_subset(run, ("pp_",)), **run}


def train_pp(dev, smi, step0):
    """Phase 12c (see the module docstring); `step0`: the `train` phase's
    step-0 loss.  Returns (record, the summed launches of (a) and (b)'s
    ranks)."""
    import torch
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel.tp import serving_mesh
    t = time.perf_counter()
    cfg = gpt.gpt3_1p3b()
    cfg.dtype = torch.bfloat16
    cfg.num_layers = TRAIN_PP_LAYERS
    mesh = serving_mesh(4, [dev] * 4, backend="gloo")
    rec = {"nvidia_smi": smi, "ranks": 4, "backend": "gloo",
           "timing_note": "four ranks time-slicing one card, gloo "
           "collectives and host-staged send/recv: not a pipeline-parallel "
           "time"}
    runs = []
    # the step-0 loss one device gives the trainers' weights (seed 0, drawn
    # on this card as phase 12's) at this depth, on the same batch
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    with torch.no_grad():
        one0 = float(gpt.loss_fn(params, *train_batch(cfg, *TRAIN_PP_BATCH),
                                 cfg))
    del params
    torch.cuda.empty_cache()
    rec["step0_loss_one_device"] = one0
    try:
        for name, kw in TRAIN_PP_LAYOUTS:
            run = pp_run(cfg, kw, TRAIN_PP_BATCH, mesh, f"train_pp {name}")
            run["step0_loss_diff_vs_one_device"] = run["losses"][0] - one0
            run["step0_loss_diff_vs_train"] = run["losses"][0] - step0
            if abs(run["step0_loss_diff_vs_one_device"]) > 0.01:
                raise AssertionError(f"train_pp {name}: step-0 loss "
                                     f"{run['losses'][0]}, one device's "
                                     f"{one0}")
            rec[name] = {"model": "gpt3_1p3b", "layers": cfg.num_layers,
                         "dtype": "bf16", "moments": "bf16", "remat": True,
                         **run}
            runs.append(run)
            emit({"run": f"train_pp {name}", **run})
        rec["a_seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        mcfg = moe_config()
        run = pp_run(mcfg, TRAIN_PP_MOE, TRAIN_PP_MOE_BATCH, mesh,
                     "train_pp moe", TRAIN_PP_MOE_STEPS)
        run["all_to_all_per_step"] = comm_subset(run, ("ep",))
        rec["moe"] = {"model": "gpt3_1p3b_moe", "layers": mcfg.num_layers,
                      "experts": mcfg.moe_num_experts, "dtype": "bf16",
                      "moments": "bf16", "remat": True, **run}
        runs.append(run)
        emit({"run": "train_pp moe", **run})
        rec["b_seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        f32 = gpt.gpt3_1p3b()
        f32.num_layers = PP_PARITY_LAYERS
        rec["parity_f32"] = mesh_parity(f32, PP_PARITY_LAYOUTS,
                                        PP_PARITY_BATCH, dev, mesh,
                                        "train_pp parity")
        emit({"run": "train_pp parity_f32", **rec["parity_f32"]})
        rec["parity_f32_moe"] = moe_parity(dev, mesh)
        rec["c_seconds"] = time.perf_counter() - t
    finally:
        mesh.close()
    torch.cuda.empty_cache()
    rec["kernels"] = [flash_case(torch.bfloat16, dev, PP_STAGE_SHAPE),
                      bwd_case(torch.bfloat16, dev, PP_STAGE_SHAPE, True)]
    summed = {k: sum(c[k] for run in runs for c in run["launches_all"])
              for k in runs[0]["launches_all"][0]}
    return rec, summed


def moe_parity(dev, mesh):
    """Phase 12c (c)'s MoE half: the MoE width at PP_PARITY_LAYERS, float32,
    one device against PP_PARITY_MOE's pp 2 x ep 2 on `mesh` (four
    ranks)."""
    import torch
    cfg = moe_config()
    cfg.dtype, cfg.num_layers = torch.float32, PP_PARITY_LAYERS
    # no drops and no aux (whose groups differ with the layout): the
    # reference's own setting for ep against one device
    cfg.moe_capacity_factor, cfg.moe_aux_weight = 8.0, 0.0
    return mesh_parity(cfg, PP_PARITY_MOE, PP_PARITY_BATCH, dev, mesh,
                       "train_pp moe parity")


# ---------------------------------------------------------------------------
# train_cp: context-parallel training (ring attention)
# ---------------------------------------------------------------------------

# (a): Llama-3-8B at full width, 2 layers, S = max_seq_len 8192 over cp 4
# (a rank's chunk [1, 2048, 32, 128]), four gloo ranks on the one card
TRAIN_CP_LAYERS = 2
TRAIN_CP_BATCH = (1, 8192)
TRAIN_CP = dict(cp=4)
TRAIN_CP_STEPS = 2              # timed, after one warm-up
# (b): float32 parity at GPT-3 1.3B width (learned positions), 2 layers
CP_PARITY_LAYOUTS = (("mp1", {}), ("cp4", dict(cp=4)),
                     ("dp2_cp2", dict(dp=2, cp=2)))
CP_PARITY_BATCH, CP_PARITY_LOSS_TOL = (4, 2048), 1e-5
# rows 2c, 5c, 6c: a ring chunk of (a), diagonal (causal) and off-diagonal
CP_CHUNK = (1, 2048, 32, 128)
# (c): one ring forward and backward at cp 4: q heads, kv heads (Llama-3)
CP_RING = dict(B=1, S=8192, H=32, KVH=8, D=128)


def ring_traffic(cfg, mc, B, S, itemsize):
    """`parallel/ring_attention.py`'s formula: the ring's sends a rank
    makes a training step (layers of its stage x microbatches x 2 (cp -
    1), half on each link) and their bytes (each 2 x B/M x S/cp x KVH/mp x
    hd x itemsize)."""
    calls = cfg.num_layers // mc.pp * mc.micro_batches * 2 * (mc.cp - 1)
    each = 2 * (B // mc.micro_batches // (mc.dp * mc.sharding)) * \
        (S // mc.cp) * (cfg.kv_heads // mc.mp) * cfg.head_dim * itemsize
    return calls, calls * each


def ring_sends(run):
    """Per rank, the ring's sends a step: calls and bytes over both links
    (host-staged under gloo: "<link>.send", one count a send)."""
    out = []
    for rank in comm_subset(run, ("cp_",)):
        sends = [v for k, v in rank.items() if k.endswith(".send")]
        out.append({"calls": sum(v["calls"] for v in sends),
                    "bytes": sum(v["bytes"] for v in sends)})
    return out


def cp_launches(cfg, mc):
    """Rows 2, 5 and 6 a step on each rank: layers of its stage x M x
    (c + 1), the chunks cp rank c sees under causal masking."""
    from paddle_tpu_torch.parallel.hybrid import coords
    return [cfg.num_layers // mc.pp * mc.micro_batches *
            (coords(mc, r)["cp"] + 1) for r in range(mc.size)]


def cp_run(cfg, kw, batch, mesh, what, steps=TRAIN_CP_STEPS):
    """`mesh_train_run` of `cfg` (bf16, bf16 moments, remat) at
    MeshConfig(**kw): the ring's sends and bytes a rank a step held to
    `ring_traffic`, rows 2, 5 and 6 to `cp_launches`."""
    import torch
    from paddle_tpu_torch.parallel import HybridParallelTrainer, MeshConfig
    mc = MeshConfig(**kw, remat=True)
    tok, lab = train_batch(cfg, *batch)
    tr = HybridParallelTrainer(cfg, mc, moment_dtype=torch.bfloat16,
                               mesh=mesh)
    run = mesh_train_run(tr, tok, lab, steps, what,
                         per_step=cp_launches(cfg, mc))
    tr.close()
    del tr
    torch.cuda.empty_cache()
    calls, nbytes = ring_traffic(cfg, mc, *batch, 2)
    sends = ring_sends(run)
    bad = [r for r, x in enumerate(sends)
           if (x["calls"], x["bytes"]) != (calls, nbytes)]
    if bad:
        raise AssertionError(f"{what}: ranks {bad} sent {sends}, the "
                             f"formula {calls} sends of {nbytes} bytes")
    return {"mesh": kw, "batch": list(batch),
            "ring_sends_per_step": sends,
            "ring_formula": {"calls": calls, "bytes": nbytes},
            "ring_per_step": comm_subset(run, ("cp_",)), **run}


def ring_check(dev, mesh):
    """(c): `ring_attention` at cp 4 on the gloo ranks (the kernel route:
    rows 2, 5 and 6 on each rank's chunks) forward and backward, against
    plain single-device attention (`attention_ref` over the full sequence,
    8 query heads at a time), bf16 and float32: max abs errors, and the
    seconds of each."""
    import torch
    from paddle_tpu_torch.incubate.kernels.flash_attention import \
        attention_ref
    from paddle_tpu_torch.parallel.ring_attention import ring_attention
    c = CP_RING
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        t = time.perf_counter()
        rng = np.random.RandomState(7)
        q, k, v = (torch.from_numpy(rng.randn(c["B"], c["S"], h, c["D"])
                                    .astype(np.float32)).to(dev, dtype)
                   for h in (c["H"], c["KVH"], c["KVH"]))
        g = torch.from_numpy(rng.randn(c["B"], c["S"], c["H"], c["D"])
                             .astype(np.float32)).to(dev, dtype)
        args = [x.clone().requires_grad_() for x in (q, k, v)]
        got = ring_attention(*args, mesh, route="kernels")
        grads = torch.autograd.grad(got, args, g)
        got = got.detach().to(dev)
        grads = [x.to(dev) for x in grads]
        G = c["H"] // c["KVH"]
        errs = {"out": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
        tops = dict(errs)
        for j in range(0, c["KVH"], 2):         # 8 query heads at a time
            hq = slice(j * G, (j + 2) * G)
            qa = q[:, :, hq].detach().requires_grad_()
            ka, va = (x[:, :, j:j + 2].detach().requires_grad_()
                      for x in (k, v))
            wide = [torch.repeat_interleave(x, G, dim=2) for x in (ka, va)]
            ref = attention_ref(qa, *wide, causal=True)
            rg = torch.autograd.grad(ref, (qa, ka, va), g[:, :, hq])
            for name, a, b in (("out", got[:, :, hq], ref),
                               ("dq", grads[0][:, :, hq], rg[0]),
                               ("dk", grads[1][:, :, j:j + 2], rg[1]),
                               ("dv", grads[2][:, :, j:j + 2], rg[2])):
                b = b.detach()
                errs[name] = max(errs[name],
                                 float((a.float() - b.float()).abs().max()))
                tops[name] = max(tops[name], float(b.float().abs().max()))
            del ref, rg, qa, ka, va, wide
        f32 = dtype == torch.float32
        lims = {n: (F32_TOL if n == "out" else BWD_F32_REL) *
                max(1.0, tops[n]) if f32 else
                (BF16_TOL["atol"] if n == "out" else BWD_BF16_REL) *
                max(1.0, tops[n]) for n in errs}
        bad = [n for n in errs if not errs[n] <= lims[n]]
        if bad:
            raise AssertionError(f"ring {dtype}: {bad} past the plain "
                                 f"attention's {errs} (limits {lims})")
        out.append({"dtype": str(dtype).replace("torch.", ""),
                    "shape": [c["B"], c["S"], c["H"], c["D"]],
                    "kv_heads": c["KVH"], "cp": mesh.mp,
                    "max_abs_err": errs, "limits": lims,
                    "seconds": time.perf_counter() - t})
        del q, k, v, g, args, got, grads
        torch.cuda.empty_cache()
    return out


def train_cp(dev, smi):
    """Phase 12d (see the module docstring).  Returns (record, the summed
    launches of (a)'s ranks)."""
    import torch
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel.tp import serving_mesh
    t = time.perf_counter()
    cfg = gpt.llama3_8b()
    cfg.dtype = torch.bfloat16
    cfg.num_layers = TRAIN_CP_LAYERS
    # the step-0 loss one device gives the trainer's weights (seed 0, drawn
    # on this card as the trainer draws them) on the same batch; random
    # logits of std 0.02 sqrt(D) put it near ln V + (0.02^2 D) / 2
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    with torch.no_grad():
        one0 = float(gpt.loss_fn(params, *train_batch(cfg, *TRAIN_CP_BATCH),
                                 cfg))
    del params
    torch.cuda.empty_cache()
    mesh = serving_mesh(4, [dev] * 4, backend="gloo")
    rec = {"nvidia_smi": smi, "ranks": 4, "backend": "gloo",
           "timing_note": "four ranks time-slicing one card, gloo "
           "collectives and host-staged send/recv: not a context-parallel "
           "time", "step0_loss_one_device": one0,
           "step0_random_logits": math.log(cfg.vocab_size) +
           0.02 ** 2 * cfg.hidden_size / 2}
    try:
        run = cp_run(cfg, TRAIN_CP, TRAIN_CP_BATCH, mesh, "train_cp")
        losses = run["losses"]
        run["step0_loss_diff_vs_one_device"] = losses[0] - one0
        if abs(losses[0] - one0) > 0.01:
            raise AssertionError(f"train_cp: step-0 loss {losses[0]}, one "
                                 f"device's {one0}")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"train_cp: loss did not fall {losses}")
        rec["llama3_8b"] = {"layers": cfg.num_layers, "dtype": "bf16",
                            "moments": "bf16", "remat": True, **run}
        emit({"run": "train_cp llama3_8b", **run})
        rec["a_seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        f32 = gpt.gpt3_1p3b()
        f32.num_layers = 2
        rec["parity_f32"] = mesh_parity(f32, CP_PARITY_LAYOUTS,
                                        CP_PARITY_BATCH, dev, mesh,
                                        "train_cp parity",
                                        loss_tol=CP_PARITY_LOSS_TOL)
        emit({"run": "train_cp parity_f32", **rec["parity_f32"]})
        rec["b_seconds"] = time.perf_counter() - t
        t = time.perf_counter()
        rec["ring"] = ring_check(dev, mesh)
        rec["c_seconds"] = time.perf_counter() - t
    finally:
        mesh.close()
    torch.cuda.empty_cache()
    summed = {k: sum(c[k] for c in run["launches_all"])
              for k in run["launches_all"][0]}
    return rec, summed


# ---------------------------------------------------------------------------
# engine_ckpt: the auto-parallel Engine's checkpoints across meshes
# ---------------------------------------------------------------------------

ENGINE_CKPT_LAYERS, ENGINE_CKPT_BATCH = 2, (4, 2048)
ENGINE_CKPT_SAVE = dict(dp=2, mp=2)
ENGINE_CKPT_RESUME = (("dp4", dict(dp=4)), ("mp2", dict(mp=2)),
                      ("cp2", dict(cp=2)))
ENGINE_CKPT_STEPS, ENGINE_CKPT_TOL = 3, 2e-4


def engine_ckpt(dev, smi):
    """Phase 12e (see the module docstring).  Returns (record, the summed
    launches of every rank in the Engine's fit and resumed steps)."""
    import os
    import shutil

    import torch
    from paddle_tpu_torch.distributed import Engine
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import MeshConfig
    from paddle_tpu_torch.parallel.tp import serving_mesh
    cfg = gpt.gpt3_1p3b()
    cfg.num_layers = ENGINE_CKPT_LAYERS
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(2),
                             dev)
    tok, lab = train_batch(cfg, *ENGINE_CKPT_BATCH, seed=2)
    n = ENGINE_CKPT_STEPS
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "engine_ckpt")
    mesh = serving_mesh(4, [dev] * 4, backend="gloo")
    rec = {"nvidia_smi": smi, "model": "gpt3_1p3b", "layers": cfg.num_layers,
           "dtype": "float32", "batch": list(ENGINE_CKPT_BATCH),
           "saved_on": ENGINE_CKPT_SAVE, "ranks": 4, "backend": "gloo"}
    launches = []

    def engine(kw, **more):
        mc = MeshConfig(**kw)
        return Engine(config=cfg, mesh_config=mc, mesh=mesh.first(mc.size),
                      **more)

    def counted(fn):
        mesh.reset_counts()
        out = fn()
        launches.extend(c["launches"] for c in mesh.rank_counts())
        return out

    try:
        # fit, save, then on to the uninterrupted curve's last steps
        a = engine(ENGINE_CKPT_SAVE, params=params)
        del params
        hist = counted(lambda: a.fit((tok, lab), epochs=n,
                                     batch_size=tok.shape[0], verbose=0))
        t = time.perf_counter()
        a.save(path)
        rec["save_seconds"] = time.perf_counter() - t
        rec["checkpoint_bytes"] = sum(
            os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
        curve = hist["loss"] + [float(a.trainer.train_step(tok, lab))
                                for _ in range(n)]
        rec["uninterrupted"] = curve
        a.trainer.close()
        del a
        for name, kw in ENGINE_CKPT_RESUME:
            b = engine(kw, seed=11)             # another init
            t = time.perf_counter()
            b.load(path)
            load_s = time.perf_counter() - t
            rest = counted(lambda: [float(b.trainer.train_step(tok, lab))
                                    for _ in range(n)])
            rel = max(abs(x - y) / abs(y) for x, y in zip(rest, curve[n:]))
            r = {"mesh": kw, "load_seconds": load_s, "losses": rest,
                 "loss_max_rel_diff_vs_curve": rel}
            if name == "cp2":
                # predict (the dense forward over the gathered parameters)
                # against evaluate (the loss through the ring) on one row
                ev = b.evaluate((tok[:2], lab[:2]), verbose=0)
                logits = b.predict(tok[:2], batch_size=1)
                ce = float(torch.nn.functional.cross_entropy(
                    logits.reshape(-1, logits.shape[-1]).float(),
                    torch.as_tensor(lab[:2]).long().reshape(-1)))
                r.update(eval_loss=ev, predict_ce=ce,
                         predict_shape=list(logits.shape))
                if not (torch.isfinite(logits).all() and
                        abs(ce - ev) <= 1e-4 * abs(ev)):
                    raise AssertionError(f"engine_ckpt: predict's loss {ce}"
                                         f", evaluate's {ev}")
                del logits
            b.trainer.close()
            del b
            torch.cuda.empty_cache()
            rec[name] = r
            if not rel <= ENGINE_CKPT_TOL:
                raise AssertionError(f"engine_ckpt {name}: {rest} off the "
                                     f"curve {curve[n:]} (rel {rel:.3g})")
    finally:
        mesh.close()
        shutil.rmtree(path, ignore_errors=True)
    torch.cuda.empty_cache()
    summed = {k: sum(c[k] for c in launches) for k in launches[0]}
    rec["launches"] = summed
    return rec, summed


def train_nccl(smi):
    """`--tp`: GPT-3 1.3B (bf16, remat, B 4, S 2048) under
    TRAIN_NCCL_LAYOUTS on a four-card NCCL mesh, against mp 1 on one card:
    losses, tokens/s, step ms, each rank's peak memory and collectives;
    then pp 4, MoE pp2 x ep2, (b) cp 4 and dp2 x cp2 (the ring's sends,
    bytes and launches against the formula) with f32 cp 4 parity against
    one device, and (c) pp2 x vpp2 x mp2."""
    import torch
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel import HybridParallelTrainer, MeshConfig
    from paddle_tpu_torch.parallel.tp import serving_mesh
    dev = torch.device("cuda", 0)
    cfg = gpt.gpt3_1p3b()
    cfg.dtype = torch.bfloat16
    tok, lab = train_batch(cfg, *TRAIN_MESH_BATCH)
    rec = {"nvidia_smi": smi, "cards": torch.cuda.device_count(),
           "model": "gpt3_1p3b", "layers": cfg.num_layers,
           "batch": list(TRAIN_MESH_BATCH), "backend": "nccl"}
    one = HybridParallelTrainer(cfg, MeshConfig(remat=True),
                                moment_dtype=torch.bfloat16, device=dev)
    rec["mp1"] = mesh_train_run(one, tok, lab, TRAIN_MESH_STEPS,
                                "train_nccl mp1")
    del one
    torch.cuda.empty_cache()
    mesh = serving_mesh(4, backend="nccl")
    try:
        for name, kw in TRAIN_NCCL_LAYOUTS:
            tr = HybridParallelTrainer(cfg, MeshConfig(**kw, remat=True),
                                       moment_dtype=torch.bfloat16,
                                       mesh=mesh)
            r = mesh_train_run(tr, tok, lab, TRAIN_MESH_STEPS,
                               f"train_nccl {name}")
            tr.close()
            del tr
            if not r["losses"][-1] < r["losses"][0]:
                raise AssertionError(f"train_nccl {name}: loss did not "
                                     f"fall {r['losses']}")
            r["step0_loss_diff_vs_mp1"] = r["losses"][0] - \
                rec["mp1"]["losses"][0]
            rec[name] = r
            emit({"run": name, **r})
        # pipeline and expert parallelism (train_pp's (a) and (b) layouts)
        pp_name, pp_kw = TRAIN_PP_LAYOUTS[0]
        r = pp_run(cfg, pp_kw, TRAIN_PP_BATCH, mesh, f"train_nccl {pp_name}")
        r["step0_loss_diff_vs_mp1"] = r["losses"][0] - \
            rec["mp1"]["losses"][0]
        rec[pp_name] = r
        emit({"run": pp_name, **r})
        r = pp_run(moe_config(), TRAIN_PP_MOE, TRAIN_PP_MOE_BATCH, mesh,
                   "train_nccl moe pp2_ep2", TRAIN_PP_MOE_STEPS)
        r["all_to_all_per_step"] = comm_subset(r, ("ep",))
        rec["moe_pp2_ep2"] = r
        emit({"run": "moe_pp2_ep2", **r})
        # (b) context parallelism over NCCL: the ring's hops on its one
        # group, against cp 1 (mp1 above); then f32 cp 4 parity
        for name, kw in TRAIN_NCCL_CP:
            r = cp_run(cfg, kw, TRAIN_MESH_BATCH, mesh,
                       f"train_nccl {name}")
            if not r["losses"][-1] < r["losses"][0]:
                raise AssertionError(f"train_nccl {name}: loss did not "
                                     f"fall {r['losses']}")
            r["step0_loss_diff_vs_mp1"] = r["losses"][0] - \
                rec["mp1"]["losses"][0]
            rec[name] = r
            emit({"run": name, **r})
        f32 = gpt.gpt3_1p3b()
        f32.num_layers = 2
        rec["cp_parity_f32"] = mesh_parity(
            f32, CP_PARITY_LAYOUTS[:2], CP_PARITY_BATCH, dev, mesh,
            "train_nccl cp parity", loss_tol=CP_PARITY_LOSS_TOL)
        emit({"run": "cp_parity_f32", **rec["cp_parity_f32"]})
        # (c) the interleaved pipeline, whose links close a cycle (the
        # last stage back to the first for the next chunk)
        pp_name, pp_kw = TRAIN_PP_LAYOUTS[1]
        r = pp_run(cfg, pp_kw, TRAIN_PP_BATCH, mesh, f"train_nccl {pp_name}")
        r["step0_loss_diff_vs_mp1"] = r["losses"][0] - \
            rec["mp1"]["losses"][0]
        rec[pp_name] = r
        emit({"run": pp_name, **r})
    finally:
        mesh.close()
    return rec


# ---------------------------------------------------------------------------
# engine_tp: tensor-parallel serving
# ---------------------------------------------------------------------------

TP_MODES = (("bucketed", None, True), ("chunked", 16, True),
            ("unfused", None, False))
TP_F32_LAYERS = 2       # the f32 streams' depth (mp 1, 2 and 4, one card)
# the bf16 runs' depth on one card: the phase took 228.5 s at all 32
# layers (its chunked mode 112.2 s: 236 steps of 64 host-staged gloo
# all-reduces), cut to 8 with phases 12d-12e in the smoke, then to 4 with
# phase 8c (PERF.md section 4); `--tp` serves all 32 on four cards
TP_LAYERS = 4


def tp_serve(params, cfg, prompts, chunk, fuse, dev, mesh, eager,
             spec_len=0, max_new=MAX_NEW, later=()):
    """Serve `prompts` x `max_new` on an `LLMEngine` over `mesh` (None: one
    device), then `later` (added once the engine has drained), every
    kernel count zeroed on every rank just before the prompts and read
    just after; each rank's launches must be L x the
    dispatches that reach each kernel (row 1: fused, chunk and verify
    programs; row 4: unfused decode; row 2: bucketed prefills), its graph
    replays the dispatches (0 eager).  Returns (outputs, record, the
    engine's pool digests by rank)."""
    import torch
    from paddle_tpu_torch.analysis.registry import over_budget
    from paddle_tpu_torch.incubate import kernels as K
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.parallel.tp import pool_digest
    eng = LLMEngine(params, cfg, num_slots=8, page_size=16,
                    max_model_len=2048, prefill_buckets=SERVE_BUCKETS,
                    prefill_chunk=chunk, fuse=fuse, spec_len=spec_len,
                    device=dev, _eager=eager, mesh=mesh)
    eng.warm_decode()
    torch.cuda.synchronize()
    if mesh is not None:
        mesh.reset_counts()
    else:
        K.reset_launches()
    steps, rids = [], []
    t0 = time.perf_counter()
    for wave in (prompts, later):
        rids += [eng.add_request(p, max_new_tokens=max_new) for p in wave]
        while eng.has_work:
            s = time.perf_counter()
            eng.step()
            steps.append(time.perf_counter() - s)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = mesh.rank_counts() if mesh is not None else [
        {"launches": K.launches(), "launches_int8": K.launches_int8(),
         "composed_calls": K.composed_calls()}]
    st = eng.stats()
    L = cfg.num_layers
    want = {"paged_attention_kernel": L * st["decode_dispatches"],
            "paged_prefill_attention_kernel":
                L * (st["fused_dispatches"] + st["chunk_dispatches"] +
                     st["verify_dispatches"]),
            "flash_attention_fwd": L * st["prefill_dispatches"]}
    for r, c in enumerate(counts):
        got = {n: c["launches"][n] for n in want}
        if got != want or any(c["composed_calls"].values()) or \
                any(c["launches_int8"].values()):
            raise AssertionError(f"engine_tp rank {r}: launches {c}, want "
                                 f"{want}")
    replays = eng.rank_replays()
    if replays != [0 if eager else dispatches(st)] * len(replays) or \
            over_budget(st):
        raise AssertionError(f"engine_tp: replays {replays} ({st}), over "
                             f"budget {over_budget(st)}")
    outs = {r: eng.outputs[r] for r in rids}
    for rid, o in outs.items():
        if len(o.token_ids) != max_new:
            raise AssertionError(f"engine_tp request {rid}: "
                                 f"{len(o.token_ids)} tokens")
    gen = sum(len(o.token_ids) for o in outs.values())
    digests = [pool_digest(eng._pool)] + (
        eng._link.worker_query("pool_digest") if mesh is not None else [])
    rec = {"mp": st["mp"], "graphs": not eager,
           "backend": mesh.backend if mesh is not None else None,
           "tokens_per_s": gen / wall, "wall_s": wall,
           "engine_steps": len(steps),
           "median_step_ms": 1e3 * float(np.median(steps)),
           "mean_step_ms": 1e3 * wall / len(steps),
           "rank_pool_bytes": eng.rank_pool_bytes(),
           "rank_replays": replays,
           "rank_launches": [{n: c["launches"][n] for n in want}
                             for c in counts],
           "launches": {n: sum(c["launches"][n] for c in counts)
                        for n in counts[0]["launches"]},
           **{k: st[k] for k in ("fused_dispatches", "decode_dispatches",
                                 "chunk_dispatches", "prefill_dispatches",
                                 "verify_dispatches", "spec_drafted_tokens",
                                 "prefix_hit_requests")},
           "executables": {k: st[k] for k in st
                           if k.endswith("_executables")}}
    del eng
    return [list(outs[r].token_ids) for r in rids], rec, digests


def tp_kernel_rows(dev):
    """Rows 1, 2 and 4 at a tensor-parallel rank's heads (Llama-3-8B at mp
    2: H16 KVH4; at mp 4: H8 KVH2; hd 128, G 4) against their plain
    versions: bf16 at both, f32 at mp 2."""
    import torch
    rows = []
    for dtype, mps in ((torch.bfloat16, (2, 4)), (torch.float32, (2,))):
        for mp in mps:
            H, KVH = 32 // mp, 8 // mp
            got = [paged_case(dtype, dev, 1, heads=(H, KVH)),
                   paged_case(dtype, dev, 16, heads=(H, KVH)),
                   flash_case(dtype, dev, (1, 1024, H, 128)),
                   decode_case(dtype, dev, PROMPT_LENS, KVH=KVH)]
            for r in got:
                r.update(dtype=str(dtype).replace("torch.", ""), mp=mp)
            rows += got
    return rows


def tp_f32_params(dev, layers=TP_F32_LAYERS):
    """Llama-3-8B width, f32, `layers` layers, seeded random weights."""
    import torch
    from paddle_tpu_torch.models import gpt
    cfg = gpt.llama3_8b()
    cfg.num_layers = layers
    return gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(3),
                           dev), cfg


def tp_f32_traffic(vocab):
    """The repeating spec prompts, and (served after them) two that share
    the first 512 tokens of the last: prefix hits under the cache."""
    prompts = spec_traffic(vocab)
    rng = np.random.RandomState(11)
    return prompts, [np.concatenate([prompts[-1][:512], rng.randint(
        0, vocab, n).astype(np.int32)]) for n in (40, 9)]


def engine_tp(params, cfg, prompts, dev, picks, smi, meshes, eager,
              f32_mps):
    """Tensor-parallel serving at Llama-3-8B width: bf16, the phase-3
    prompts x 32 at mp 2 over meshes[2], fused bucketed, fused chunked and
    unfused; first tokens against the dense forward (`picks`, margin >
    0.05); each rank's pool half mp=1's.  Then f32 at TP_F32_LAYERS layers
    with spec decoding (SPEC_LEN) and the prefix cache on: greedy streams
    byte-equal at mp 1 and `f32_mps`.  Returns the phase record."""
    import torch
    from paddle_tpu_torch.quantization import kv_page_bytes
    rec, firsts = {"nvidia_smi": smi}, []
    mp = 2
    for mode, chunk, fuse in TP_MODES:
        outs, r, _ = tp_serve(params, cfg, prompts, chunk, fuse, dev,
                              meshes[mp], eager)
        full = 513 * kv_page_bytes(cfg, 16)     # mp=1's default pool
        if r["rank_pool_bytes"] != [full // mp] * mp:
            raise AssertionError(f"engine_tp: rank pools "
                                 f"{r['rank_pool_bytes']}, want {full // mp}"
                                 f" each")
        r["kv_pool_bytes_mp1"] = full
        firsts += [{"mode": mode, **c} for c in check_first_tokens(
            picks, {i: _Out(o) for i, o in enumerate(outs)}, f"tp {mode}")]
        rec[mode] = r
        torch.cuda.empty_cache()
    rec["first_token"] = firsts
    p32, c32 = tp_f32_params(dev)
    first, later = tp_f32_traffic(c32.vocab_size)
    streams = {}
    for m in (1, *f32_mps):
        streams[m], rec[f"f32_mp{m}"], _ = tp_serve(
            p32, c32, first, 16, True, dev,
            meshes[m] if m > 1 else None, eager if m > 1 else False,
            spec_len=SPEC_LEN, later=later)
    for m in f32_mps:
        if streams[m] != streams[1]:
            raise AssertionError(f"engine_tp f32: mp={m} streams differ "
                                 f"from mp=1")
    if not rec["f32_mp1"]["prefix_hit_requests"]:
        raise AssertionError("engine_tp f32: no prefix hit")
    rec["f32_streams_equal"] = [1, *f32_mps]
    del p32
    torch.cuda.empty_cache()
    return rec


class _Out:
    """A token list as `check_first_tokens` reads an output."""

    def __init__(self, tokens):
        self.token_ids = tokens


# ---------------------------------------------------------------------------
# engine_fleet_tp: tensor-parallel replicas behind the fleet and the door
# ---------------------------------------------------------------------------

# the f32 streams' depth (two replicas on one mp 2 mesh against one mp 1
# engine); the bf16 fleet runs at engine_tp's TP_LAYERS on one card, at 32
# under --tp
FLEET_TP_F32_LAYERS = 2


def fleet_tp_launches(mesh, runs, L, what):
    """Every rank's kernel counts since the mesh's last reset: row 1 (the
    paged kernel) L x the fused, chunk and verify dispatches of the
    replicas `runs` ({label: stats}) on each rank, row 2 L x their bucketed
    prefills, nothing composed and no int8 lane.  Returns the ranks'
    launches summed."""
    want = {"paged_prefill_attention_kernel": L * sum(
                st["fused_dispatches"] + st["chunk_dispatches"] +
                st["verify_dispatches"] for st in runs.values()),
            "flash_attention_fwd": L * sum(st["prefill_dispatches"]
                                           for st in runs.values())}
    counts = mesh.rank_counts()
    for r, c in enumerate(counts):
        got = {n: c["launches"][n] for n in want}
        if got != want or not got["paged_prefill_attention_kernel"] or \
                any(c["composed_calls"].values()) or \
                any(c["launches_int8"].values()):
            raise AssertionError(f"{what} rank {r}: launches {c}, want "
                                 f"{want}")
    return {n: sum(c["launches"][n] for c in counts)
            for n in counts[0]["launches"]}


def fleet_tp_weights(fleet, what):
    """One copy of the weights on every rank: the followers on the leader's
    rank-0 shard and, on each worker, its shard (a worker holds one
    shard's bytes however many replicas attach); every replica's pool
    shard mp=1's / mp.  Returns the record."""
    from paddle_tpu_torch.parallel.hybrid import _leaves
    leader = next(iter(fleet.engines.values()))
    mesh = leader.mesh
    shard = sum(t.numel() * t.element_size() for t in _leaves(leader.params))
    held = [mesh.query(r, "weight_bytes") for r in range(1, mesh.mp)]
    pools = {l: e.rank_pool_bytes() for l, e in fleet.engines.items()}
    if not fleet.shared_executables() or held != [shard] * (mesh.mp - 1) or \
            any(p != [p[0]] * mesh.mp for p in pools.values()):
        raise AssertionError(f"{what}: worker weights {held}, a shard "
                             f"{shard}; pools {pools}")
    return {"weight_shard_bytes": shard, "worker_weight_bytes": held,
            "rank_pool_bytes": pools}


def fleet_tp_digests(fleet):
    """{label: every rank's pool digest} of a fleet's replicas."""
    from paddle_tpu_torch.parallel.tp import pool_digest
    return {l: [pool_digest(e._pool)] + e._link.worker_query("pool_digest")
            for l, e in fleet.engines.items()}


def fleet_tp_stepped(fleet, first, extra):
    """The two-turn sessions with the loops stopped: each turn submitted
    (routed) whole, then every replica stepped in turn until idle, so each
    replica's steps do not depend on timing (an eager and a graph fleet
    meet the same steps).  Returns the turns' token lists."""
    def turn(prompts):
        hs = [fleet.submit(p, session=f"s{i}", max_new_tokens=MAX_NEW)
              for i, p in enumerate(prompts)]
        while any(e.has_work for e in fleet.engines.values()):
            for e in fleet.engines.values():
                if e.has_work:
                    e.step()
        return [list(fleet.result(h, timeout=FLEET_WAIT_S).token_ids)
                for h in hs]
    t1 = turn(first)
    t2 = turn([np.concatenate([p, np.asarray(o, np.int32), x])
               for p, o, x in zip(first, t1, extra)])
    return t1, t2


def engine_fleet_tp(params, cfg, prompts, dev, smi, mesh):
    """Phase 6j (see the module docstring): two replicas on one mp 2 gloo
    mesh on the card, eager.  Returns (record, the ranks' launches)."""
    import gc
    import shutil
    import tempfile

    import torch
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.inference.router import EngineFleet
    V, L = cfg.vocab_size, cfg.num_layers
    knobs = dict(fleet_knobs(dev), mesh=mesh, _eager=True)
    rng = np.random.RandomState(18)
    first = prompts[:FLEET_SESSIONS]
    extra = [rng.randint(0, V, FLEET_EXTRA).astype(np.int32) for _ in first]
    door_p = rng.randint(0, V, 200).astype(np.int32)
    drop_p = rng.randint(0, V, 100).astype(np.int32)
    rec = {"nvidia_smi": smi, "mp": mesh.mp, "backend": mesh.backend,
           "layers": L, "timing_note": "two ranks on one card, gloo, "
           "eager: not a tensor-parallel time"}

    # (a) two replicas, affinity: the sessions through the loops
    fleet = EngineFleet(params, cfg, engine_kwargs=knobs)
    rec["weights"] = fleet_tp_weights(fleet, "engine_fleet_tp")
    fleet.warm()
    torch.cuda.synchronize()
    mesh.reset_counts()
    with fleet:
        _, o2, _, r = fleet_sessions(fleet, first, extra, V)
        runs = {l: locked_stats(e) for l, e in fleet.engines.items()}
    launches = fleet_tp_launches(mesh, runs, L, "engine_fleet_tp a")
    kv = [p.size + MAX_NEW - 1 for p in first]
    if r["turn2_cached_tokens"] != kv or \
            len(set(r["replicas"])) != 2:
        raise AssertionError(f"engine_fleet_tp a: replicas {r['replicas']},"
                             f" turn-2 cached {r['turn2_cached_tokens']}, "
                             f"the turn-1 KV {kv}")
    r["rank_replays"] = {l: e.rank_replays()
                         for l, e in fleet.engines.items()}
    rec["a_affinity_2"] = r
    # (b) the front door over the same fleet
    with fleet:
        rec["b_front_door"] = front_door(fleet, door_p, drop_p)
    del fleet, o2
    gc.collect()

    # (c) prefill/decode roles over one store, at mp 2
    root = tempfile.mkdtemp()
    try:
        fleet = EngineFleet(params, cfg, roles="P:D",
                            engine_kwargs=dict(knobs, spill_dir=root))
        with fleet:
            hs = [fleet.submit(p, session=f"s{i}", max_new_tokens=MAX_NEW)
                  for i, p in enumerate(first[:2])]
            dis = [fleet.result(h, timeout=FLEET_WAIT_S) for h in hs]
            fleet.check_invariants()
        fst = fleet.stats()["disagg"]
        de = fleet.engines[fleet.decode_pool[0]]
        if None in dis or fst["handoffs"] != 2 or \
                de.stats()["kv_tier"]["restores"] == 0:
            raise AssertionError(f"engine_fleet_tp c: {fst}, {dis}")
        rec["c_disagg"] = {**fst, "cached_tokens": [o.cached_tokens
                                                    for o in dis],
                           "decode_kv_tier": de.stats()["kv_tier"]}
        del fleet, de
        gc.collect()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()

    # (d) f32 at FLEET_TP_F32_LAYERS: every stream of the two replicas
    # equals the same requests on one mp 1 engine, each replica's sessions
    # in its order (so the engine's batches are the replica's)
    p32, c32 = tp_f32_params(dev, FLEET_TP_F32_LAYERS)
    fleet = EngineFleet(p32, c32, engine_kwargs=dict(knobs))
    t1, t2 = fleet_tp_stepped(fleet, first, extra)
    labels = [fleet._sessions[f"s{i}"] for i in range(len(first))]
    del fleet
    gc.collect()
    for label in sorted(set(labels)):
        mine = [i for i, l in enumerate(labels) if l == label]
        one = LLMEngine(p32, c32, **fleet_knobs(dev))
        for turn, prompts in ((t1, [first[i] for i in mine]),
                              (t2, [np.concatenate([first[i], np.asarray(
                                  t1[i], np.int32), extra[i]])
                                  for i in mine])):
            rids = [one.add_request(p, max_new_tokens=MAX_NEW)
                    for p in prompts]
            one.run()
            if [turn[i] for i in mine] != \
                    [list(one.outputs[r].token_ids) for r in rids]:
                raise AssertionError(f"engine_fleet_tp d: {label}'s f32 "
                                     f"streams differ from one mp 1 "
                                     f"engine's")
        del one
    rec["d_f32_streams_equal_mp1"] = {"layers": FLEET_TP_F32_LAYERS,
                                      "requests": 2 * len(first),
                                      "replicas": labels}
    del p32
    gc.collect()
    torch.cuda.empty_cache()
    return rec, launches


def fleet_tp_nccl(params, cfg, prompts, meshes, smi):
    """`--tp` (a): Llama-3-8B at 32 layers, NCCL, graphs.  Two pre-built
    mp 2 engines on cards 0-1 and 2-3 behind one fleet (dp 2 x mp 2), and
    `replicas=2` on one mp 4 mesh: the sessions stepped with the loops
    stopped give every rank's pool and the streams bitwise the eager
    fleet's on the same meshes; then the sessions through the loops,
    tokens/s and turn-2 TTFT against one mp engine of the same degree."""
    import gc

    import torch
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.inference.router import EngineFleet
    V = cfg.vocab_size
    rng = np.random.RandomState(18)
    first = prompts[:FLEET_SESSIONS]
    extra = [rng.randint(0, V, FLEET_EXTRA).astype(np.int32) for _ in first]
    d0, d2 = torch.device("cuda", 0), torch.device("cuda", 2)
    p2 = {k: ({n: t.to(d2) for n, t in v.items()} if isinstance(v, dict)
              else v.to(d2)) for k, v in params.items()}

    def dp2_mp2(eager):
        a = LLMEngine(params, cfg, mesh=meshes["a"],
                      **fleet_knobs(d0), _eager=eager)
        b = LLMEngine(p2, cfg, mesh=meshes["b"], **fleet_knobs(d2),
                      _eager=eager)
        return EngineFleet(engines=[a, b])

    def mp4(eager):
        return EngineFleet(params, cfg, engine_kwargs=dict(
            fleet_knobs(d0), mesh=meshes[4], _eager=eager))

    rec = {"nvidia_smi": smi, "layers": cfg.num_layers, "backend": "nccl"}
    failed = []
    for name, build, single in (("mp4_replicas2", mp4, meshes[4]),
                                ("dp2_mp2", dp2_mp2, meshes["a"])):
        try:
            rec[name] = fleet_tp_layout(name, build, single, params, cfg,
                                        first, extra)
        except Exception:
            import traceback
            failed.append(name)
            rec[name] = {"error": traceback.format_exc()}
        emit({"run": f"fleet_tp {name}", **rec[name]})
        gc.collect()
        torch.cuda.empty_cache()
    del p2
    torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"--tp a: {failed} failed: " + " ".join(
            rec[n]["error"] for n in failed))
    return rec


def fleet_tp_layout(name, build, single, params, cfg, first, extra):
    """One layout of `fleet_tp_nccl`: `build(eager)` makes its fleet,
    `single` is the mesh of the one mp engine it is timed against."""
    import gc

    import torch
    from paddle_tpu_torch.inference.engine import LLMEngine
    from paddle_tpu_torch.inference.router import EngineFleet
    V, d0 = cfg.vocab_size, torch.device("cuda", 0)
    t = time.perf_counter()
    runs = {}
    for eager in (True, False):
        fleet = build(eager)
        fleet.warm()
        toks = fleet_tp_stepped(fleet, first, extra)
        runs[eager] = (toks, fleet_tp_digests(fleet),
                       {l: e.rank_replays()
                        for l, e in fleet.engines.items()})
        del fleet
        gc.collect()
        torch.cuda.empty_cache()
    (te, de, _), (tg, dg, replays) = runs[True], runs[False]
    if te != tg or de != dg:
        bad = {l: [r for r, (a, b) in enumerate(zip(de[l], dg[l]))
                   if a != b] for l in de}
        raise AssertionError(f"--tp a {name}: graph streams or pools "
                             f"differ from eager ({bad})")
    r = {"graph_equals_eager": True, "rank_replays": replays}
    fleet = build(False)
    fleet.warm()
    with fleet:
        _, _, _, r["fleet"] = fleet_sessions(fleet, first, extra, V)
    if single.mp == 4:
        r["weights"] = fleet_tp_weights(fleet, f"--tp a {name}")
    del fleet
    gc.collect()
    one = EngineFleet(engines=[LLMEngine(
        params, cfg, mesh=single, **fleet_knobs(d0))])
    one.warm()
    with one:
        _, _, _, r["one_engine"] = fleet_sessions(one, first, extra, V)
    r["one_engine_mp"] = single.mp
    del one
    gc.collect()
    torch.cuda.empty_cache()
    r["seconds"] = time.perf_counter() - t
    return r


def fleet_tp_four_cards(smi):
    """`--tp` (a) on four cards: Llama-3-8B at 32 layers, bf16, seeded
    random weights; meshes of cards 0-1, 2-3 and 0-3."""
    import torch
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel.tp import serving_mesh
    dev = torch.device("cuda", 0)
    cfg = gpt.llama3_8b()
    cfg.dtype = torch.bfloat16
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    meshes = {"a": serving_mesh(2, ["cuda:0", "cuda:1"], backend="nccl"),
              "b": serving_mesh(2, ["cuda:2", "cuda:3"], backend="nccl"),
              4: serving_mesh(4, backend="nccl")}
    try:
        return fleet_tp_nccl(params, cfg, prompts, meshes, smi)
    finally:
        for m in meshes.values():
            m.close()


# --tp (d): the host copies of the pool at mp 1, 2 and 4 (NCCL, graphs)
HOST_COPY_MODES = ("swap", "spill")


def host_copy_run(params, cfg, dev, mesh, mode):
    """One engine over `mesh` (None: one card), graphs, 32 layers: "swap"
    serves engine_overload (b)'s traffic (phase 3's prompts x MAX_NEW on
    OVERLOAD_PAGES pages, optimistic admission, swap preemption,
    OVERLOAD_PRIORITIES); "spill" engine_tier's waves 1-3 on TIER_PAGES
    pages (wave 2 spills wave 1's prefixes, wave 3 restores them).  Each
    step's wall, split into the steps that queued a gather to the host
    (a swap-out or a spill), the steps that staged pages from it (a
    swap-in or a restore), the steps that did both, and the rest; the
    engine's host-copy ms (its
    waits for the gathers' copies and its staging of the scatters) per
    page moved; under mp the host slabs' bytes after `warm_swap` and at
    the end."""
    import torch
    from paddle_tpu_torch.inference.engine import LLMEngine
    kw = dict(admission="optimistic", preempt="swap",
              num_pages=OVERLOAD_PAGES, kv_tier=False) if mode == "swap" \
        else dict(num_pages=TIER_PAGES)
    eng = LLMEngine(params, cfg, num_slots=8, page_size=16,
                    max_model_len=2048, prefill_buckets=SERVE_BUCKETS,
                    device=dev, mesh=mesh, **kw)
    eng.warm_decode()
    eng.warm_swap()
    slabs = getattr(eng, "_slabs", None)    # mp: the shared host slabs
    slab_warm = slabs.nbytes if slabs is not None else None
    pc = eng._port_c
    steps = {"d2h": [], "h2d": [], "both": [], "other": []}

    def wave(prompts, priorities=None):
        rids = [eng.add_request(p, max_new_tokens=MAX_NEW,
                                priority=(priorities or [0] * 8)[i])
                for i, p in enumerate(prompts)]
        while eng.has_work:
            out0, in0 = pc["swap_out_dispatches"], pc["swap_in_dispatches"]
            t0 = time.perf_counter()
            eng.step()
            ms = (time.perf_counter() - t0) * 1e3
            d2h = pc["swap_out_dispatches"] > out0
            h2d = pc["swap_in_dispatches"] > in0
            kind = "both" if d2h and h2d else "d2h" if d2h else \
                "h2d" if h2d else "other"
            steps[kind].append(ms)
        return [eng.outputs[r].token_ids for r in rids]

    torch.cuda.synchronize()
    t = time.perf_counter()
    rng = np.random.RandomState(0)          # phase 3's prompts
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    if mode == "swap":
        wave(prompts, list(OVERLOAD_PRIORITIES))
    else:
        flush, returning = tier_waves(cfg.vocab_size, prompts)
        replies = wave(prompts)
        wave(flush)
        wave(returning(replies))
    torch.cuda.synchronize()
    st = eng.stats()
    tier = st["kv_tier"]
    pages = 2 * st["swapped_pages"] + tier["spills"] + \
        -(-tier["restored_tokens"] // 16)
    if not (steps["d2h"] or steps["both"]) or \
            not (steps["h2d"] or steps["both"]):
        raise AssertionError(f"host_copy {mode} mp={eng.mp}: no host copy "
                             f"({st})")
    rec = {"mp": eng.mp, "mode": mode, "wall_s": time.perf_counter() - t,
           "pages_moved": pages, "swap_ms": st["swap_ms"],
           "host_copy_ms_per_page": st["swap_ms"] / pages,
           "preempt_swaps": st["preempt_swaps"], "spills": tier["spills"],
           "restores": tier["restores"], "slab_bytes_warm": slab_warm,
           "slab_bytes": slabs.nbytes if slabs is not None else None}
    for k, v in steps.items():
        rec[f"{k}_steps"] = len(v)
        rec[f"{k}_median_ms"] = float(np.median(v)) if v else None
        rec[f"{k}_mean_ms"] = float(np.mean(v)) if v else None
    del eng
    return rec


def host_copy_tp(smi):
    """`--tp` (d): Llama-3-8B at 32 layers, bf16, graphs, the
    host-copy traffic of `host_copy_run` at mp 1 (card 0), 2 and 4
    (NCCL)."""
    import gc

    import torch
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel.tp import serving_mesh
    dev = torch.device("cuda", 0)
    cfg = gpt.llama3_8b()
    cfg.dtype = torch.bfloat16
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    rec = {"nvidia_smi": smi}
    for m in (1, 2, 4):
        mesh = serving_mesh(m, backend="nccl") if m > 1 else None
        try:
            for mode in HOST_COPY_MODES:
                r = host_copy_run(params, cfg, dev, mesh, mode)
                rec[f"{mode}_mp{m}"] = r
                emit({"run": f"host_copy {mode} mp{m}", **r})
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            if mesh is not None:
                mesh.close()
    return rec


def tp_four_cards(smi):
    """`--tp`: on four cards, NCCL meshes of 2 and 4 ranks, the phase-3
    prompts x 32 at Llama-3-8B width in bf16, fused bucketed and chunked:
    each rank's CUDA graphs replay once a dispatch, the streams and every
    rank's pool bitwise the eager engine's on the same mesh; step ms and
    tokens/s at mp 1, 2 and 4; f32 streams at 2 layers equal at mp 1, 2
    and 4.  Returns the phase record."""
    import torch
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.parallel.tp import serving_mesh
    dev = torch.device("cuda", 0)
    if torch.cuda.device_count() < 4:
        raise AssertionError("--tp needs four cards")
    cfg = gpt.llama3_8b()
    cfg.dtype = torch.bfloat16
    params = gpt.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in PROMPT_LENS]
    picks = forward_picks(params, cfg, dict(enumerate(prompts)))
    meshes = {m: serving_mesh(m, backend="nccl") for m in (2, 4)}
    rec = {"nvidia_smi": smi, "cards": torch.cuda.device_count()}
    try:
        for mode, chunk in (("bucketed", None), ("chunked", 16)):
            for m in (1, 2, 4):
                mesh = meshes.get(m)
                eager, re_, dig_e = tp_serve(params, cfg, prompts, chunk,
                                             True, dev, mesh, True)
                emit({"run": f"{mode}_mp{m}", "graphs": False, **re_})
                graph, r, dig = tp_serve(params, cfg, prompts, chunk, True,
                                         dev, mesh, False)
                emit({"run": f"{mode}_mp{m}", "graphs": True, **r})
                if graph != eager:
                    raise AssertionError(f"--tp {mode} mp={m}: graph and "
                                         f"eager streams differ")
                bad = [i for i, (a, b) in enumerate(zip(dig, dig_e))
                       if a != b]
                if bad:
                    raise AssertionError(f"--tp {mode} mp={m}: graph and "
                                         f"eager pools differ on ranks {bad}")
                check_first_tokens(picks, {i: _Out(o) for i, o in
                                           enumerate(graph)},
                                   f"--tp {mode} mp={m}")
                r["eager"] = {k: re_[k] for k in (
                    "tokens_per_s", "median_step_ms", "mean_step_ms")}
                r["graph_equals_eager"] = True
                rec[f"{mode}_mp{m}"] = r
                torch.cuda.empty_cache()
        del params
        torch.cuda.empty_cache()
        p32, c32 = tp_f32_params(dev)
        first, later = tp_f32_traffic(c32.vocab_size)
        streams = {m: tp_serve(p32, c32, first, 16, True, dev,
                               meshes.get(m), False, spec_len=SPEC_LEN,
                               later=later)[0]
                   for m in (1, 2, 4)}
        if not streams[1] == streams[2] == streams[4]:
            raise AssertionError("--tp f32: streams differ across mp")
        rec["f32_streams_equal"] = [1, 2, 4]
    finally:
        for m in meshes.values():
            m.close()
    return rec


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    tp_only = sys.argv[1:] == ["--tp"]
    if sys.argv[1:] and not tp_only:
        print("usage: chip_smoke.py [--tp]", file=sys.stderr)
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
    if tp_only:
        phases = (("engine_tp_nccl", tp_four_cards),
            ("engine_fleet_tp_nccl", fleet_tp_four_cards),
            ("host_copy_tp", host_copy_tp), ("train_nccl", train_nccl))
        failed = []
        for name, fn in phases:
            # a phase that fails is reported and the next one runs; the
            # run fails at the end
            t = time.perf_counter()
            try:
                rec = fn(smi)
            except Exception:
                import traceback
                failed.append(name)
                emit({"phase": name, "seconds": time.perf_counter() - t,
                      "error": traceback.format_exc()})
                continue
            emit({"phase": name, "seconds": time.perf_counter() - t, **rec})
        if failed:
            print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
            return 1
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0

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
        rows += [paged_case(dtype, dev, T) for T in (1, 16, SPEC_LEN + 1,
                                                     TAIL_T)]
        # decode: the smoke prompts' lengths at Llama-3-8B's heads, then
        # hd 64 and 256 at G 1 and 8 with lengths ending mid-page
        rows.append(decode_case(dtype, dev, PROMPT_LENS))
        rows += [decode_case(dtype, dev, (37, 1000, 16, 1), hd=hd, G=G,
                             KVH=4) for hd in (64, 256) for G in (1, 8)]
        # the int8 lanes at the same serving shapes, page 16 and 32
        for page in (16, INT8_PAGE):
            rows += [paged_case(dtype, dev, T, page, int8=True)
                     for T in (1, 16)]
            if page == INT8_PAGE:       # the int8 spec engine's page
                rows.append(paged_case(dtype, dev, SPEC_LEN + 1, page,
                                       int8=True))
            rows.append(decode_case(dtype, dev, PROMPT_LENS, page=page,
                                    int8=True))
        rows.append(paged_case(dtype, dev, TAIL_T, INT8_PAGE, int8=True))
        for r in rows:
            r["dtype"] = str(dtype).replace("torch.", "")
        results += rows
    # row 2c: a ring chunk of train_cp (a), diagonal and off-diagonal
    for causal in (True, False):
        results.append({**flash_case(torch.bfloat16, dev, CP_CHUNK, causal),
                        "dtype": "bfloat16", "row": "2c"})
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
        # bucketed: every one-shot prefill bucket is a graph on graphs
        want = rec["executables"]["prefill_executables"] if chunk is None \
            else 0
        if (rec["bucket_graphs"], erec["bucket_graphs"]) != (want, 0):
            raise AssertionError(f"engine_graphs {mode}: bucket graphs "
                                 f"{rec['bucket_graphs']} / "
                                 f"{erec['bucket_graphs']}, want {want}")
        rec6[mode] = {"graphs": {k: rec[k] for k in keys},
                      "eager": {k: erec[k] for k in keys},
                      "bucket_graphs": rec["bucket_graphs"],
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
    rec_p, firsts = {}, []
    hit_names = None
    for mode, chunk, fuse, int8 in (("bucketed", None, True, False),
                                    ("chunked", 16, True, False),
                                    ("unfused_bucketed", None, False, False),
                                    ("int8_bucketed", None, True, True)):
        outs, sent, rec_p[mode] = serve_prefix(params, cfg, dev, chunk,
                                               fuse, int8)
        # the first token of every hit request against the dense forward
        # over its whole prompt (over the dequantized weights for int8)
        hit_names = [n for n, c in rec_p[mode]["cached_tokens"].items() if c]
        ref_params = dequantized_params(params, cfg) if int8 else params
        picks = forward_picks(ref_params, cfg,
                              {n: sent[n] for n in hit_names})
        del ref_params
        firsts += [{"mode": mode, **c}
                   for c in check_first_tokens(picks, outs, mode)]
        torch.cuda.empty_cache()
    off = {mode: serve_prefix(params, cfg, dev, chunk,
                              prefix_cache=False)[2]
           for mode, chunk in (("bucketed", None), ("chunked", 16))}
    cmp_keys = ("prefilled_tokens", "prefix_cached_tokens", "ttft_ms",
                "tokens_per_s", "mean_step_ms", "median_step_ms",
                "engine_steps", "prefill_dispatches", "chunk_dispatches",
                "prefill_chunks")
    emit({"phase": "engine_prefix", "seconds": time.perf_counter() - t,
          "system_prompt": PREFIX_SYSTEM, "donor_own": PREFIX_OWN,
          "hit_requests": hit_names, **rec_p,
          "with_and_without_cache": {
              mode: {"with": {k: rec_p[mode][k] for k in cmp_keys},
                     "without": {k: rec[k] for k in cmp_keys}}
              for mode, rec in off.items()},
          "no_prefix_cache": off, "first_token": firsts})

    t = time.perf_counter()
    rec_s, lossless_off = engine_spec(params, cfg, dev)
    emit({"phase": "engine_spec", "seconds": time.perf_counter() - t,
          "spec_len": SPEC_LEN, "pattern": SPEC_PATTERN,
          "int8_requests": SPEC_INT8_REQUESTS, **rec_s,
          "lossless_spec_off": lossless_off})

    t = time.perf_counter()
    rec_o = engine_overload(params, cfg, prompts, dev, {
        "chunked": (chunked, rec4), "bucketed": (bucketed, rec3),
        "unfused": (unfused["bucketed"], rec5["bucketed"]),
        "int8": (int8_runs["bucketed"], rec_q["bucketed"])})
    emit({"phase": "engine_overload", "seconds": time.perf_counter() - t,
          "pressure_steps": OVERLOAD_PRESSURE, "requests_de":
          OVERLOAD_REQUESTS, **rec_o})

    t = time.perf_counter()
    rec_t = engine_tier(params, cfg, dev, prompts, smi)
    emit({"phase": "engine_tier", "seconds": time.perf_counter() - t,
          "max_new": MAX_NEW, "fresh": TIER_FRESH,
          "int8_requests": TIER_INT8_REQUESTS, **rec_t})

    t = time.perf_counter()
    obs_outs, rec_obs = engine_obs(params, cfg, prompts, dev, smi)
    emit({"phase": "engine_obs", "seconds": time.perf_counter() - t,
          "greedy_agreement_with_bucketed": agreement(bucketed, obs_outs),
          **rec_obs})

    t = time.perf_counter()
    rec_fleet = engine_fleet(params, cfg, prompts, dev, smi)
    emit({"phase": "engine_fleet", "seconds": time.perf_counter() - t,
          "sessions": FLEET_SESSIONS, "max_new": MAX_NEW,
          "turn2_extra": FLEET_EXTRA, **rec_fleet})

    t = time.perf_counter()
    modes = (("bucketed", bucketed), ("chunked", chunked),
             ("unfused_bucketed", unfused["bucketed"]),
             ("unfused_chunked", unfused["chunked"]))
    picks = forward_picks(params, cfg, {rid: prompts[rid] for rid in (0, 1)})
    checks = [{"mode": mode, **c} for mode, outs in modes
              for c in check_first_tokens(picks, outs, mode)]
    emit({"phase": "first_token", "seconds": time.perf_counter() - t,
          "checks": checks})

    t = time.perf_counter()
    rec = decode_logits(params, cfg, prompts[0], dev)
    emit({"phase": "decode_logits", "seconds": time.perf_counter() - t,
          **rec})

    t = time.perf_counter()
    from paddle_tpu_torch.parallel.tp import serving_mesh
    # the first TP_LAYERS layers of phase 3's weights (views, no copy)
    tp_cfg = copy.copy(cfg)
    tp_cfg.num_layers = TP_LAYERS
    tp_params = dict(params, blocks={k: v[:TP_LAYERS]
                                     for k, v in params["blocks"].items()})
    tp_picks = forward_picks(tp_params, tp_cfg, dict(enumerate(prompts)))
    # two ranks share the one card: gloo, eager (a CUDA graph cannot
    # capture gloo); the meshes' workers start together
    tp_meshes = {m: serving_mesh(m, [dev] * m, backend="gloo")
                 for m in (2, 4)}
    try:
        rec_tp = engine_tp(tp_params, tp_cfg, prompts, dev, tp_picks, smi,
                           tp_meshes, eager=True, f32_mps=(2, 4))
        rec_tp["kernels"] = tp_kernel_rows(dev)
        emit({"phase": "engine_tp", "seconds": time.perf_counter() - t,
              "mp": 2, "layers": TP_LAYERS, "backend": "gloo",
              "timing_note": "two ranks on one "
              "card, gloo, eager: not a tensor-parallel time", **rec_tp})
        t = time.perf_counter()
        rec_ftp, ftp_launches = engine_fleet_tp(tp_params, tp_cfg, prompts,
                                                dev, smi, tp_meshes[2])
        emit({"phase": "engine_fleet_tp", "seconds": time.perf_counter() - t,
              **rec_ftp})
        del tp_params
    finally:
        for m in tp_meshes.values():
            m.close()

    t = time.perf_counter()
    rec_gen = generate_phase(params, cfg, dev)
    del params
    torch.cuda.empty_cache()
    rec_gen["f32_vs_engine"] = generate_f32_vs_engine(dev)
    emit({"phase": "generate", "seconds": time.perf_counter() - t,
          **rec_gen})

    t = time.perf_counter()
    rec_layer, kept = layer_api(dev, smi)
    emit({"phase": "layer_api", "seconds": time.perf_counter() - t,
          **rec_layer})

    t = time.perf_counter()
    rec_ops = ops_api(dev, smi, kept)
    torch.cuda.empty_cache()
    emit({"phase": "ops_api", "seconds": time.perf_counter() - t, **rec_ops})

    t = time.perf_counter()
    rec_nn = nn_api(dev, smi, kept)
    del kept
    torch.cuda.empty_cache()
    emit({"phase": "nn_api", "seconds": time.perf_counter() - t, **rec_nn})

    t = time.perf_counter()
    rec_nt = nn_train(dev, smi)
    torch.cuda.empty_cache()
    emit({"phase": "nn_train", "seconds": time.perf_counter() - t,
          **rec_nt})

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
    # rows 5c, 6c: a ring chunk of train_cp (a), diagonal and off-diagonal
    for causal in (True, False):
        bwd.append({**bwd_case(torch.bfloat16, dev, CP_CHUNK, causal),
                    "dtype": "bfloat16", "row": "5c, 6c"})
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
    torch.cuda.empty_cache()

    t = time.perf_counter()
    rec_mesh, mesh_launches = train_mesh(dev, smi)
    emit({"phase": "train_mesh", "seconds": time.perf_counter() - t,
          **rec_mesh})

    t = time.perf_counter()
    rec_pp, pp_launches = train_pp(dev, smi, rec8["losses"][0])
    emit({"phase": "train_pp", "seconds": time.perf_counter() - t,
          **rec_pp})

    t = time.perf_counter()
    rec_cp, cp_launches_sum = train_cp(dev, smi)
    emit({"phase": "train_cp", "seconds": time.perf_counter() - t,
          **rec_cp})

    t = time.perf_counter()
    rec_ck, ck_launches = engine_ckpt(dev, smi)
    emit({"phase": "engine_ckpt", "seconds": time.perf_counter() - t,
          **rec_ck})

    t = time.perf_counter()
    rec_moe = engine_moe(dev)
    emit({"phase": "engine_moe", "seconds": time.perf_counter() - t,
          **rec_moe})

    t = time.perf_counter()
    rec_tm = train_moe(dev)
    emit({"phase": "train_moe", "seconds": time.perf_counter() - t,
          **rec_tm})

    t = time.perf_counter()
    rec_bert = bert(dev)
    emit({"phase": "bert", "seconds": time.perf_counter() - t, **rec_bert})

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
            *rec_p.values(), *rec_s.values(), *rec_o.values(),
            *(m["tier"] for m in rec_t.values() if isinstance(m, dict)
              and "tier" in m), rec_obs, rec_fleet,
            *(rec_tp[m] for m, _, _ in TP_MODES), rec9, rec7, rec8,
            rec_gen, rec_layer, rec_ops, rec_nn, rec_nt, rec_moe,
            rec_moe["int8"],
            rec_tm,
            rec_bert,
            {"launches": ftp_launches},
            {"launches": mesh_launches}, {"launches": pp_launches},
            {"launches": cp_launches_sum}, {"launches": ck_launches})
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
