"""The port's `amp` (`paddle_tpu_torch/amp/`) against the JAX package's, on
the CPU.

- Twins of the five `tests/test_amp.py` cases: each runs in both packages
  and keeps its own assertions; dtypes equal, values within float32 2e-5
  (bf16 outputs within BF16_TOL, one bf16 rounding apart).
- A 2-layer D 64 post-LN encoder (`nn.Embedding`, `nn.TransformerEncoder`,
  `nn.Linear` head) with the reference's weights (`torch_nn_cases.carry`),
  fine-tuned three O1 bf16 steps through `GradScaler` + `AdamW`: the
  embedding, encoder, head and loss dtypes equal the reference's; the
  losses within LOSS_REL; every grad within GRAD_REL times the step's
  largest reference grad (both packages run bf16 matmuls on the CPU, whose
  roundings differ in the last bf16 bit, and the key projections' biases
  get pure rounding noise: their true grad is 0); the parameters' updates
  since the start within UPDATE_REL of the reference's, all tensors
  together (Adam's first steps move a weight by about lr whatever its
  grad's size, so a grad near 0 may flip an update's sign), and every
  parameter within two such flips a step.
- The inf skip (one inf in one grad: every parameter and moment unchanged,
  the scale halved), `minimize` (backward run only where none ran) and the
  scaler's `state_dict` against the reference's.
- O2 under `auto_cast`: bf16 inputs give both packages the same dtypes and
  values; a float32 input makes the reference's cast recurse without end,
  where the port runs it.  The `amp` namespace, its lists and `debugging`
  over the flags.
"""
import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from torch_nn_cases import carry
from torch_op_test import on_cpu  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=8e-3, atol=8e-3)   # one bf16 rounding (2**-8) apart
LOSS_REL = 2e-3         # the encoder's losses, relative
GRAD_REL = 2e-2         # each grad: max abs err <= GRAD_REL * the step's
#                         largest |ref grad|
UPDATE_REL = 0.2        # ||port update - ref update|| / ||ref update||
LR = 1e-3
VOCAB, D, HEADS, FFN, LAYERS, B, S = 50, 64, 4, 128, 2, 2, 8


def rnd(*s):
    return np.random.RandomState(5).rand(*s).astype(np.float32)


def f32(t):
    return np.asarray(t.astype("float32").numpy(), np.float64)


# ---- the five tests/test_amp.py cases, on both packages ----

def case_white_and_black(ns):
    x = ns.to_tensor(rnd(4, 4))
    y = ns.to_tensor(rnd(4, 4))
    with ns.amp.auto_cast(level="O1", dtype="bfloat16"):
        out = ns.matmul(x, y)
    assert out.dtype.name == "bfloat16"
    with ns.amp.auto_cast(level="O1", dtype="bfloat16"):
        s = ns.nn.functional.softmax(x)
    assert s.dtype.name == "float32"
    return f32(out), s.numpy()


def case_off_outside(ns):
    x = ns.to_tensor(rnd(4, 4))
    out = ns.matmul(x, x)
    assert out.dtype.name == "float32"
    return (out.numpy(),)


def case_scales_and_unscales(ns):
    lin = carry_from_seed(ns, lambda m: m.nn.Linear(4, 4))
    scaler = ns.amp.GradScaler(init_loss_scaling=128.0)
    loss = lin(ns.to_tensor(rnd(2, 4))).sum()
    scaler.scale(loss).backward()
    g_scaled = lin.weight.grad.numpy().copy()
    scaler.step(ns.optimizer.SGD(learning_rate=0.0,
                                 parameters=lin.parameters()))
    scaler.update()
    np.testing.assert_allclose(lin.weight.grad.numpy(), g_scaled / 128.0,
                               rtol=1e-6)
    return g_scaled, lin.weight.grad.numpy()


def case_skips_on_inf(ns):
    lin = carry_from_seed(ns, lambda m: m.nn.Linear(2, 2))
    opt = ns.optimizer.SGD(learning_rate=1.0, parameters=lin.parameters())
    scaler = ns.amp.GradScaler(init_loss_scaling=4.0)
    x = ns.to_tensor(np.array([[np.inf, 1.0]], np.float32))
    loss = lin(x).sum()
    scaler.scale(loss).backward()
    before = lin.weight.numpy().copy()
    scaler.step(opt)
    scaler.update()
    np.testing.assert_allclose(lin.weight.numpy(), before)  # update skipped
    assert scaler.get_loss_scaling() < 4.0  # scale decreased
    return lin.weight.numpy(), np.float32(scaler.get_loss_scaling())


def case_o2_decorate(ns):
    net = carry_from_seed(ns, lambda m: m.nn.Sequential(m.nn.Linear(4, 4),
                                                       m.nn.LayerNorm(4)))
    ns.amp.decorate(net, level="O2", dtype="bfloat16")
    assert net[0].weight.dtype.name == "bfloat16"
    assert net[1].weight.dtype.name == "float32"  # norm excluded
    return tuple(f32(p) for p in net.parameters())


_REF_STATES = {}


def carry_from_seed(ns, build):
    """The reference's layer (seeded), or the port's twin with the weights
    the reference's had when it was built (by `build`'s code)."""
    if ns is R:
        R.seed(3)
        layer = build(R)
        _REF_STATES[build.__code__] = {
            k: v.numpy().copy() for k, v in layer.state_dict().items()}
        return layer
    layer = build(P)
    missing, unexpected = layer.set_state_dict(_REF_STATES[build.__code__])
    assert not missing and not unexpected
    return layer


CASES = {"autocast_white_list_casts_matmul": case_white_and_black,
         "autocast_off_outside_context": case_off_outside,
         "grad_scaler_scales_and_unscales": case_scales_and_unscales,
         "grad_scaler_skips_on_inf": case_skips_on_inf,
         "o2_decorate_casts_params": case_o2_decorate}


@pytest.mark.parametrize("name", sorted(CASES))
def test_amp_twin(name):
    want = CASES[name](R)
    got = CASES[name](P)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        tol = BF16_TOL if name == "autocast_white_list_casts_matmul" \
            else TOL
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), **tol,
                                   err_msg=name)


# ---- an O1 fine-tune of a small encoder through GradScaler + AdamW ----

def encoder(ns):
    nn = ns.nn
    ns.seed(0)
    return [nn.Embedding(VOCAB, D),
            nn.TransformerEncoder(nn.TransformerEncoderLayer(
                D, HEADS, FFN, dropout=0.0, activation="gelu"), LAYERS),
            nn.Linear(D, VOCAB)]


def encoder_pair():
    ref = encoder(R)
    return ref, [carry(r, p) for r, p in zip(ref, encoder(P))]


def batches(steps=3):
    rng = np.random.RandomState(1)
    out = []
    for _ in range(steps):
        ids = rng.randint(0, VOCAB, (B, S))
        labels = np.where(rng.rand(B, S) < 0.5, rng.randint(0, VOCAB, (B, S)),
                          -100)
        out.append((ids, labels))
    return out


def o1_forward(ns, layers, ids, labels):
    """The forward and loss under O1 bf16: (dtype names of the embedding,
    encoder, head and loss outputs, loss)."""
    emb, enc, head = layers
    with ns.amp.auto_cast(level="O1", dtype="bfloat16"):
        h = emb(ns.to_tensor(ids))
        e = enc(h)
        logits = head(e)
        loss = ns.nn.functional.cross_entropy(logits, ns.to_tensor(labels),
                                              ignore_index=-100)
    return [t.dtype.name for t in (h, e, logits, loss)], loss


def adamw(ns, layers):
    return ns.optimizer.AdamW(
        learning_rate=LR, weight_decay=0.01,
        parameters=[p for lyr in layers for p in lyr.parameters()],
        grad_clip=ns.nn.ClipGradByGlobalNorm(1.0))


def fine_tune(ns, layers, data):
    """Three O1 steps: per step (dtypes, loss, grads before the step,
    parameters after it), the scaler and the optimizer."""
    opt = adamw(ns, layers)
    scaler = ns.amp.GradScaler()
    params = [p for lyr in layers for p in lyr.parameters()]
    steps = []
    for ids, labels in data:
        dtypes, loss = o1_forward(ns, layers, ids, labels)
        scaler.scale(loss).backward()
        scaler.unscale_(opt)
        grads = [p.grad.numpy().copy() for p in params]
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        steps.append((dtypes, float(loss), grads,
                      [p.numpy().copy() for p in params]))
    return steps, scaler, opt


@pytest.fixture(scope="module")
def tuned():
    ref, port = encoder_pair()
    data = batches()
    return fine_tune(R, ref, data), fine_tune(P, port, data)


def test_o1_fine_tune_dtypes_are_the_references(tuned):
    (want, _, _), (got, _, _) = tuned
    for (wd, *_), (gd, *_) in zip(want, got):
        assert gd == wd
    assert got[0][0] == ["float32", "float32", "bfloat16", "float32"]


def test_o1_fine_tune_losses_grads_and_parameters(tuned):
    (want, wscaler, _), (got, gscaler, _) = tuned
    assert gscaler.get_loss_scaling() == wscaler.get_loss_scaling() == 65536.0
    start = [p.numpy() for lyr in encoder(R) for p in lyr.parameters()]
    for step, ((_, wl, wg, wp), (_, gl, gg, gp)) in enumerate(zip(want, got)):
        assert abs(gl - wl) <= LOSS_REL * abs(wl), (step, gl, wl)
        top = max(np.abs(w).max() for w in wg)
        for i, (g, w) in enumerate(zip(gg, wg)):
            err = np.abs(g - w).max()
            assert err <= GRAD_REL * top, (step, i, err, top)
        off = sum(np.square(g - w).sum() for g, w in zip(gp, wp))
        moved = sum(np.square(w - a).sum() for w, a in zip(wp, start))
        assert np.sqrt(off / moved) <= UPDATE_REL, (step, off, moved)
        for i, (g, w) in enumerate(zip(gp, wp)):
            np.testing.assert_allclose(g, w, rtol=0, atol=2 * LR * (step + 1),
                                       err_msg=f"step {step} param {i}")
    assert got[-1][1] < got[0][1]


def inf_step(ns, layers, data):
    """One O1 backward, an inf written into one grad, `scaler.step`:
    (parameters and moments before and after, the scale after update)."""
    opt = adamw(ns, layers)
    scaler = ns.amp.GradScaler(init_loss_scaling=1024.0)
    params = [p for lyr in layers for p in lyr.parameters()]
    ids, labels = data[0]
    _, loss = o1_forward(ns, layers, ids, labels)
    scaler.scale(loss).backward()
    scaler.step(opt)             # one good step, so the moments exist
    scaler.update()
    opt.clear_grad()
    _, loss = o1_forward(ns, layers, ids, labels)
    scaler.scale(loss).backward()
    g = params[3].grad.numpy().copy()
    g.flat[5] = np.inf
    params[3].grad = ns.to_tensor(g)

    def state():
        return [p.numpy().copy() for p in params] + \
            [np.asarray(v.numpy()).copy() for k, v in
             sorted(opt.state_dict().items()) if k.endswith("moment1")
             or k.endswith("moment2")]
    before = state()
    scaler.step(opt)
    scaler.update()
    return before, state(), scaler.get_loss_scaling()


def test_inf_grad_skips_the_step_and_halves_the_scale():
    ref, port = encoder_pair()
    data = batches(1)
    for ns, layers in ((R, ref), (P, port)):
        before, after, scale = inf_step(ns, layers, data)
        assert len(before) == len(after) > 0
        for b, a in zip(before, after):
            np.testing.assert_array_equal(a, b)
        assert scale == 512.0, ns.__name__


def minimize_case(ns, backward_first):
    lin = carry_from_seed(ns, lambda m: m.nn.Linear(3, 2))
    opt = ns.optimizer.SGD(learning_rate=0.5, parameters=lin.parameters())
    scaler = ns.amp.GradScaler(init_loss_scaling=8.0)
    scaled = scaler.scale(lin(ns.to_tensor(rnd(4, 3))).sum())
    if backward_first:
        scaled.backward()
    scaler.minimize(opt, scaled)
    return lin.weight.numpy(), lin.bias.numpy(), lin.weight.grad.numpy()


@pytest.mark.parametrize("backward_first", [False, True])
def test_minimize_runs_backward_only_where_none_ran(backward_first):
    want = minimize_case(R, backward_first)
    got = minimize_case(P, backward_first)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    # one backward either way: the unscaled grad is the plain grad
    np.testing.assert_allclose(got[2], np.tile(rnd(4, 3).sum(0), (2, 1)).T,
                               **TOL)


def test_scaler_state_dict_is_the_references():
    sds = []
    for ns in (R, P):
        s = ns.amp.GradScaler(init_loss_scaling=16.0, incr_every_n_steps=2)
        s._found_inf = True
        s.update()                      # 8.0, decr_count reset
        s.update()
        s.update()                      # two good steps: 16.0
        s.update()
        sd = s.state_dict()
        t = ns.amp.GradScaler()
        t.load_state_dict(sd)
        sds.append((sd, t.state_dict(), t.get_loss_scaling()))
    assert sds[0] == sds[1]
    assert sds[1][0]["scale"] == 16.0 and sds[1][0]["incr_count"] == 1


def test_amp_namespace_and_support_queries():
    def names(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and n != "annotations"}
    assert names(P.amp) == names(R.amp)
    assert P.amp.is_bfloat16_supported()
    assert not P.amp.is_float16_supported()      # the CPU is the place here
    prev = P.get_device()
    P.set_device("gpu:0")
    try:
        assert P.amp.is_float16_supported()
    finally:
        P.set_device(prev)
    from paddle_tpu.amp import amp_lists as ra
    from paddle_tpu_torch.amp import amp_lists as pa
    assert pa.white_list() == ra.white_list()
    assert pa.black_list() == ra.black_list()
    assert P.amp.amp_guard is P.amp.auto_cast
    assert P.amp.AmpScaler is P.amp.GradScaler


def o2_forward(ns, x):
    lin = carry_from_seed(ns, lambda m: m.nn.Linear(4, 4))
    ns.amp.decorate(lin, level="O2")
    with ns.amp.auto_cast(level="O2", dtype="bfloat16"):
        y = lin(x)
        z = ns.nn.functional.layer_norm(y, [4])
        w = ns.exp(y)                   # black: float32
        v = y + 1.0                     # gray under O1, low under O2
    return [y, z, w, v]


def test_o2_forward_runs_low_but_the_black_list():
    """bf16 inputs: both packages agree.  A float32 input to a low op: the
    reference's cast, itself an `apply` op that O2 casts again, recurses
    without end; the port leaves the cast op alone and runs it low."""
    x = rnd(3, 4)
    want = o2_forward(R, R.to_tensor(x).astype("bfloat16"))
    got = o2_forward(P, P.to_tensor(x).astype("bfloat16"))
    names = ["bfloat16", "float32", "float32", "bfloat16"]
    assert [t.dtype.name for t in want] == [t.dtype.name for t in got] == \
        names
    for g, w in zip(got, want):
        np.testing.assert_allclose(f32(g), f32(w), **BF16_TOL)
    with pytest.raises(RecursionError):
        o2_forward(R, R.to_tensor(x))
    got32 = o2_forward(P, P.to_tensor(x))
    assert [t.dtype.name for t in got32] == names
    for g, w in zip(got32, got):
        np.testing.assert_array_equal(f32(g), f32(w))


def test_debugging_over_the_flags(capsys):
    for ns in (R, P):
        with ns.amp.debugging.collect_operator_stats():
            assert ns.get_flags("low_precision_op_list")[
                "FLAGS_low_precision_op_list"] == 1
        assert ns.get_flags("low_precision_op_list")[
            "FLAGS_low_precision_op_list"] == 0
        ns.amp.debugging.enable_tensor_checker()
        assert ns.get_flags("check_nan_inf")["FLAGS_check_nan_inf"]
        ns.amp.debugging.disable_tensor_checker()
        assert not ns.get_flags("check_nan_inf")["FLAGS_check_nan_inf"]
        cfg = ns.amp.debugging.TensorCheckerConfig(enable=True,
                                                   output_dir="x")
        assert cfg.enable and cfg.output_dir == "x"
    out = capsys.readouterr().out
    assert out.count("op list") == 2
