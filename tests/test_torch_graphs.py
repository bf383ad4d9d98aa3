"""The port's step programs (`inference/graphs.py`) vs the JAX reference, on
the CPU, where the staged-buffer step runs eagerly (capture and replay are
the card's: `test_torch_cuda_kernels.py`).

- Greedy streams of `LLMEngine` in all four modes (fused and unfused,
  bucketed and chunked) against the reference engine's on the same traffic
  (`gpt_tiny`/`llama_tiny` at 64, fp32, the reference's weights through
  `models/convert.py`), under the tie rule of `test_torch_engine.py`.
- `stats()`'s five `*_executables` equal the reference engine's `stats()`
  on that traffic in each mode, within `SERVE_PROGRAM_BUDGET`, which
  equals the reference's dict.
- `warm_decode()` builds the decode-side program and leaves the pool's
  non-null pages and the streams as they were.
- `StepProgram` refuses partial staging and a run without staging, and its
  build takes back the counts of its warm-up.
"""
import jax
import numpy as np
import pytest
import torch

from paddle_tpu.analysis.registry import \
    SERVE_PROGRAM_BUDGET as REF_BUDGET
from paddle_tpu.inference.engine import LLMEngine as JaxEngine
from paddle_tpu.models import gpt as G
from paddle_tpu_torch.analysis.registry import (SERVE_PROGRAM_BUDGET,
                                                over_budget, program_counts)
from paddle_tpu_torch.incubate import kernels as K
from paddle_tpu_torch.incubate.kernels.rms_norm import rms_norm_fused
from paddle_tpu_torch.inference.engine import LLMEngine
from paddle_tpu_torch.inference.graphs import StepProgram
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from test_torch_engine import PRESETS, _assert_greedy_parity, _serve

# the reference's program-count traffic: 2 slots, page 8, prompts of 5 and
# 20 tokens
GEOMETRY = dict(num_slots=2, page_size=8, max_model_len=64)
MODES = {"fused_bucketed": (True, None), "fused_chunked": (True, 8),
         "unfused_bucketed": (False, None), "unfused_chunked": (False, 8)}
EXEC_KEYS = ("decode_executables", "verify_executables",
             "prefill_executables", "copy_executables", "swap_executables")
# what the reference's stats() reads on this traffic
REF_TABLE = {"fused_bucketed": (1, 0, 2, 0, 0),
             "fused_chunked": (1, 0, 0, 0, 0),
             "unfused_bucketed": (1, 0, 2, 0, 0),
             "unfused_chunked": (1, 0, 1, 0, 0)}


def _traffic(vocab):
    rng = np.random.RandomState(3)
    return [(rng.randint(0, vocab, n).astype(np.int32), 6) for n in (5, 20)]


@pytest.fixture(scope="module")
def reference():
    """name -> (jax cfg, jax params, port cfg, port params, requests,
    {mode: (reference outputs, reference stats)})"""
    out = {}
    for name, (jax_preset, port_preset) in PRESETS.items():
        cfg, tcfg = jax_preset(64), port_preset(64)
        params = G.init_params(cfg, jax.random.key(2))
        tparams = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, params), tcfg, "cpu")
        reqs = _traffic(cfg.vocab_size)
        runs = {}
        for mode, (fuse, chunk) in MODES.items():
            eng = JaxEngine(params, cfg, prefill_chunk=chunk, fuse=fuse,
                            prefix_cache=False, spec_len=0, **GEOMETRY)
            outs = _serve(eng, reqs)
            runs[mode] = (outs, eng.stats())
        out[name] = (cfg, params, tcfg, tparams, reqs, runs)
    return out


def _engine(tparams, tcfg, mode, **kw):
    fuse, chunk = MODES[mode]
    return LLMEngine(tparams, tcfg, prefill_chunk=chunk, fuse=fuse,
                     device="cpu", **GEOMETRY, **kw)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", list(PRESETS))
def test_staged_step_streams_match_reference(reference, name, mode):
    cfg, params, tcfg, tparams, reqs, runs = reference[name]
    eng = _engine(tparams, tcfg, mode)
    outs = _serve(eng, reqs)
    _assert_greedy_parity(runs[mode][0], outs, params, cfg)
    st = eng.stats()
    # the CPU runs every program eagerly: no graph, no replay
    assert st["graph_replays"] == 0
    assert all(p.graph is None for p in eng._programs.values())
    assert eng.cache.pages_in_use() == 0 and not eng.has_work


@pytest.mark.parametrize("mode", list(MODES))
def test_program_counts_match_reference(reference, mode):
    _, _, tcfg, tparams, reqs, runs = reference["gpt_tiny"]
    ref_stats = runs[mode][1]
    eng = _engine(tparams, tcfg, mode)
    before = {k: eng.stats()[k] for k in EXEC_KEYS}
    assert set(before.values()) == {0}          # nothing built yet
    _serve(eng, reqs)
    st = eng.stats()
    got = tuple(st[k] for k in EXEC_KEYS)
    assert got == tuple(ref_stats[k] for k in EXEC_KEYS) == REF_TABLE[mode]
    assert not over_budget(st)
    assert program_counts(st)["decode_side_executables"] <= 1


def test_budget_equals_reference():
    assert SERVE_PROGRAM_BUDGET == REF_BUDGET
    st = dict.fromkeys(EXEC_KEYS, 0)
    st["prefill_executables"] = 3
    assert over_budget(st) == {"prefill_executables": (3, 2)}
    assert program_counts(st)["total_executables"] == 3


@pytest.mark.parametrize("mode", list(MODES))
def test_warm_decode_leaves_pages_and_streams(reference, mode):
    _, _, tcfg, tparams, reqs, runs = reference["llama_tiny"]
    cold = _engine(tparams, tcfg, mode)
    warm = _engine(tparams, tcfg, mode)
    pool0 = {n: t.clone() for n, t in warm._pool.items()}
    warm.warm_decode()
    st = warm.stats()
    assert st["decode_executables"] == 1 and st["prefill_executables"] == 0
    for n, t in warm._pool.items():     # [L, P, page, KVH, hd]: page 0 null
        assert torch.equal(t[:, 1:], pool0[n][:, 1:])
    assert warm._c["fused_dispatches"] == warm._c["decode_dispatches"] == 0
    a, b = _serve(cold, reqs), _serve(warm, reqs)
    assert {r: o.token_ids for r, o in a.items()} == \
        {r: o.token_ids for r, o in b.items()}
    assert warm.stats()["decode_executables"] == 1


def test_sampled_streams_do_not_depend_on_warm_decode(reference):
    """The noise is drawn from the engine's generator before each step, and
    warming draws none: a warmed sampling engine gives the cold one's
    streams."""
    _, _, tcfg, tparams, reqs, _ = reference["llama_tiny"]
    streams = []
    for warm in (False, True):
        eng = _engine(tparams, tcfg, "fused_chunked", temperature=0.8,
                      top_k=20, seed=4)
        if warm:
            eng.warm_decode()
        streams.append({r: o.token_ids for r, o in _serve(eng, reqs).items()})
    assert streams[0] == streams[1]


def _toy_program(calls):
    def body(x, y):
        calls.append(1)
        rms_norm_fused.launches += 1        # stands in for a kernel launch
        return x * 2 + y
    inputs = {"x": ((3,), torch.int32, 0), "y": ((3,), torch.int32, 1)}
    return StepProgram("toy", body, inputs, torch.device("cpu"))


def test_step_program_staging_rules():
    prog = _toy_program([])
    with pytest.raises(ValueError, match="stage every input"):
        prog.stage(x=[1, 2, 3])
    prog.stage(x=[1, 2, 3], y=5)
    assert prog.built and prog.inputs["y"].tolist() == [5, 5, 5]
    prog.run()
    assert prog.result().tolist() == [7, 9, 11]
    with pytest.raises(RuntimeError, match="stage the inputs"):
        prog.run()
    # staging copies the values: a later edit of the source reaches nothing
    src = np.array([4, 4, 4], np.int32)
    prog.stage(x=src, y=0)
    src[:] = 0
    prog.run()
    assert prog.result().tolist() == [8, 8, 8]


def test_step_program_build_takes_back_its_counts():
    calls = []
    prog = _toy_program(calls)
    K.reset_launches()
    prog.build()
    assert calls == [1] and prog.out.tolist() == [1, 1, 1]   # inert inputs
    assert K.launches()["rms_norm_fused"] == 0
    prog.build()                                            # idempotent
    for _ in range(3):
        prog.stage(x=[1, 1, 1], y=0)
        prog.run()
    assert len(calls) == 4 and K.launches()["rms_norm_fused"] == 3
    K.reset_launches()
