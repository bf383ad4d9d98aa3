"""The port's `optimizer` and `optimizer.lr` (`paddle_tpu_torch/optimizer/`)
against the JAX package's, on the CPU.

- Twins of `tests/test_optimizer.py`: each case runs in both packages,
  keeps its own assertions, and the port's numbers equal the reference's
  at float32 2e-5 abs and rel.
- The ten optimizers take the same parameters (a `Linear` with
  `ParamAttr(learning_rate=0.5)` on its weight, its values set from numpy,
  and a free vector) and the same gradients for 5 steps, each with a scheduler or a
  float decay, a clip, and for AdamW `apply_decay_param_fun` and
  `lr_ratio`: parameters, every accumulator and the `state_dict` keys
  (`{param.name}_{acc}`, `LR_Scheduler`, `global_step`) equal the
  reference's.  LBFGS also runs with a closure.
- Every scheduler's 30-step sequence equals the reference's exactly
  (`ReduceOnPlateau` fed the same losses), and so do their state dicts.
- A `weight_decay` that is not a float reaches the missing `regularizer`
  module and raises ImportError in both; `minimize` steps once, running
  backward only where none ran; the pure `_functional_update` forms give
  the reference's parameters and states.
"""
import math

import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from torch_op_test import on_cpu  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
NAMES = ["SGD", "Momentum", "Adam", "AdamW", "Adamax", "Adagrad",
         "Adadelta", "RMSProp", "Lamb", "LBFGS"]


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), **TOL,
                               err_msg=what)


# ---- twins of tests/test_optimizer.py ----

def quad_problem(ns, opt_name, steps=50, **kw):
    """Minimize ||x - 3||^2; the final x."""
    x = ns.to_tensor(np.zeros((4,), np.float32), stop_gradient=False)
    x.persistable = True
    opt = getattr(ns.optimizer, opt_name)(parameters=[x], **kw)
    for _ in range(steps):
        loss = ((x - 3.0) ** 2).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
    return x.numpy()


@pytest.mark.parametrize("name,kw,steps,atol", [
    ("SGD", {"learning_rate": 0.1}, 100, 1e-2),
    ("Momentum", {"learning_rate": 0.02, "momentum": 0.9}, 150, 2e-2)],
    ids=["sgd", "momentum"])
def test_converges(name, kw, steps, atol):
    outs = {}
    for ns in (R, P):
        outs[ns] = quad_problem(ns, name, steps, **kw)
        np.testing.assert_allclose(outs[ns], np.full(4, 3.0), atol=atol)
    close(outs[P], outs[R])


def test_adam_matches_reference_impl():
    lr, b1, b2, eps = 0.1, 0.9, 0.999, 1e-8
    outs = {}
    for ns in (R, P):
        x = ns.to_tensor(np.array([1.0, -2.0], np.float32),
                         stop_gradient=False)
        opt = ns.optimizer.Adam(learning_rate=lr, parameters=[x])
        ref = np.array([1.0, -2.0], np.float64)
        m, v = np.zeros(2), np.zeros(2)
        seq = []
        for step in range(1, 6):
            (x * x).sum().backward()
            g = 2 * ref
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mh, vh = m / (1 - b1 ** step), v / (1 - b2 ** step)
            ref = ref - lr * mh / (np.sqrt(vh) + eps)
            opt.step()
            opt.clear_grad()
            np.testing.assert_allclose(x.numpy(), ref, rtol=1e-4, atol=1e-5)
            seq.append(x.numpy())
        outs[ns] = seq
    close(outs[P], outs[R])


@pytest.mark.parametrize("name,kw", [
    ("Adam", {"learning_rate": 0.1}), ("AdamW", {"learning_rate": 0.1}),
    ("Adamax", {"learning_rate": 0.1}), ("Adagrad", {"learning_rate": 0.5}),
    ("Adadelta", {"learning_rate": 5.0}),
    ("RMSProp", {"learning_rate": 0.05}), ("Lamb", {"learning_rate": 0.05})],
    ids=lambda v: v if isinstance(v, str) else "")
def test_optimizers_reduce_loss(name, kw):
    losses = {}
    for ns in (R, P):
        x = ns.to_tensor(np.full((4,), 5.0, np.float32), stop_gradient=False)
        opt = getattr(ns.optimizer, name)(parameters=[x], **kw)
        seq = []
        for _ in range(30):
            loss = ((x - 3.0) ** 2).sum()
            seq.append(float(loss.numpy()))
            loss.backward()
            opt.step()
            opt.clear_grad()
        assert seq[-1] < seq[0] * 0.5
        losses[ns] = seq
    close(losses[P], losses[R])


def test_optimizer_state_dict_roundtrip():
    for ns in (R, P):
        x = ns.to_tensor(np.ones((3,), np.float32), stop_gradient=False)
        opt = ns.optimizer.Adam(learning_rate=0.1, parameters=[x])
        (x * x).sum().backward()
        opt.step()
        state = opt.state_dict()
        opt2 = ns.optimizer.Adam(learning_rate=0.1, parameters=[x])
        opt2.set_state_dict(state)
        assert opt2._global_step == opt._global_step
        m1 = opt._accumulators["moment1"][id(x)]
        m2 = opt2._accumulators["moment1"][id(x)]
        np.testing.assert_allclose(np.asarray(m1), np.asarray(m2))


def test_lr_schedulers():
    for ns in (R, P):
        lr_mod = ns.optimizer.lr
        s = lr_mod.StepDecay(0.1, step_size=2, gamma=0.5)
        vals = []
        for _ in range(5):
            vals.append(round(s(), 6))
            s.step()
        assert vals == [0.1, 0.1, 0.05, 0.05, 0.025]
        c = lr_mod.CosineAnnealingDecay(1.0, T_max=10)
        assert abs(c() - 1.0) < 1e-9
        for _ in range(10):
            c.step()
        assert abs(c()) < 1e-6
        w = lr_mod.LinearWarmup(0.1, warmup_steps=5, start_lr=0.0, end_lr=0.1)
        assert w() == 0.0
        for _ in range(5):
            w.step()
        assert abs(w() - 0.1) < 1e-9
        n = lr_mod.NoamDecay(d_model=512, warmup_steps=10, learning_rate=1.0)
        lrs = []
        for _ in range(20):
            lrs.append(n())
            n.step()
        assert max(lrs) == lrs[10]


def test_scheduler_with_optimizer():
    for ns in (R, P):
        x = ns.to_tensor(np.ones((2,), np.float32), stop_gradient=False)
        sched = ns.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.1)
        opt = ns.optimizer.SGD(learning_rate=sched, parameters=[x])
        assert abs(opt.get_lr() - 0.1) < 1e-9
        sched.step()
        assert abs(opt.get_lr() - 0.01) < 1e-9


def test_grad_clip_in_optimizer():
    moved = {}
    for ns in (R, P):
        x = ns.to_tensor(np.full((4,), 100.0, np.float32), stop_gradient=False)
        opt = ns.optimizer.SGD(learning_rate=1.0, parameters=[x],
                               grad_clip=ns.nn.ClipGradByGlobalNorm(1.0))
        (x * x).sum().backward()
        before = x.numpy().copy()
        opt.step()
        moved[ns] = x.numpy() - before
        np.testing.assert_allclose(np.linalg.norm(moved[ns]), 1.0, rtol=1e-4)
    close(moved[P], moved[R])


# ---- the ten optimizers on the same parameters and gradients ----

_g = np.random.RandomState(43)
LIN_W, LIN_B = _g.randn(4, 3).astype(np.float32), _g.randn(3) \
    .astype(np.float32)
FREE = _g.randn(5).astype(np.float32)
STEPS = 5
GRADS = [[_g.randn(4, 3).astype(np.float32), _g.randn(3).astype(np.float32),
          _g.randn(5).astype(np.float32)] for _ in range(STEPS)]
GRADS[2][2] *= 50.0          # one large step, for the clips


def make_params(ns):
    lin = ns.nn.Linear(4, 3, weight_attr=ns.ParamAttr(learning_rate=0.5))
    lin.weight.set_value(LIN_W)
    lin.bias.set_value(LIN_B)
    free = ns.to_tensor(FREE, stop_gradient=False)
    ps = [lin.weight, lin.bias, free]
    for i, p in enumerate(ps):
        p.name = f"p{i}"
    return ps


def build(ns, name, ps):
    O, lr, nn = ns.optimizer, ns.optimizer.lr, ns.nn
    if name == "SGD":
        return O.SGD(lr.StepDecay(0.1, 2, 0.5), ps, weight_decay=0.01,
                     grad_clip=nn.ClipGradByGlobalNorm(1.0))
    if name == "Momentum":
        return O.Momentum(0.05, 0.9, ps, use_nesterov=True,
                          weight_decay=0.01)
    if name == "Adam":
        return O.Adam(lr.CosineAnnealingDecay(0.05, 5), parameters=ps,
                      weight_decay=0.02,
                      grad_clip=nn.ClipGradByGlobalNorm(2.0))
    if name == "AdamW":
        return O.AdamW(0.05, parameters=ps, weight_decay=0.1,
                       apply_decay_param_fun=lambda n: n != "p1",
                       lr_ratio=lambda p: 0.5 if p.name == "p0" else 1.0,
                       grad_clip=nn.ClipGradByNorm(1.0))
    if name == "Adamax":
        return O.Adamax(0.05, parameters=ps, weight_decay=0.01)
    if name == "Adagrad":
        return O.Adagrad(0.1, parameters=ps, initial_accumulator_value=0.1,
                         grad_clip=nn.ClipGradByValue(0.5))
    if name == "Adadelta":
        return O.Adadelta(1.0, parameters=ps, weight_decay=0.01)
    if name == "RMSProp":
        return O.RMSProp(lr.ExponentialDecay(0.05, 0.9), momentum=0.5,
                         centered=True, parameters=ps)
    if name == "Lamb":
        return O.Lamb(0.05, parameters=ps,
                      exclude_from_weight_decay_fn=lambda p: p.name == "p2",
                      grad_clip=nn.ClipGradByGlobalNorm(1.0))
    return O.LBFGS(0.1, parameters=ps)


def five_steps(ns, name):
    ps = make_params(ns)
    opt = build(ns, name, ps)
    trail = []
    for step in range(STEPS):
        for p, g in zip(ps, GRADS[step]):
            p.grad = ns.to_tensor(g)
        opt.step()
        if isinstance(opt._learning_rate, ns.optimizer.lr.LRScheduler):
            opt._learning_rate.step()
        trail.append([p.numpy() for p in ps])
    return trail, opt.state_dict()


def state_values(state):
    return {k: v for k, v in state.items() if hasattr(v, "numpy")}


@pytest.mark.parametrize("name", NAMES)
def test_five_steps_on_the_same_gradients(name):
    (got, got_state), (want, want_state) = five_steps(P, name), \
        five_steps(R, name)
    for step, (g, w) in enumerate(zip(got, want)):
        for i, (a, b) in enumerate(zip(g, w)):
            close(a, b, f"{name} step {step} p{i}")
    assert list(got_state) == list(want_state)
    # LBFGS steps outside `_apply_optimize`, so its count stays 0
    assert got_state["global_step"] == want_state["global_step"] == \
        (0 if name == "LBFGS" else STEPS)
    for k, v in state_values(want_state).items():
        close(got_state[k].numpy(), v.numpy(), f"{name} {k}")
    if "LR_Scheduler" in want_state:
        assert got_state["LR_Scheduler"] == want_state["LR_Scheduler"]


def test_accumulators_are_float32_on_the_parameters_device():
    ps = make_params(P)
    opt = build(P, "Adam", ps)
    for p, g in zip(ps, GRADS[0]):
        p.grad = P.to_tensor(g)
    opt.step()
    for name, store in opt._accumulators.items():
        for p in ps:
            acc = store[id(p)]
            assert str(acc.dtype) == "torch.float32"
            assert acc.device == p._t.device
            if name.endswith("_pow"):
                assert acc.ndim == 0


def test_parameter_updates_bump_no_version():
    """The optimizers write parameters as the reference assigns `_data`: a
    graph recorded before the step still differentiates after it."""
    ps = make_params(P)
    opt = build(P, "AdamW", ps)
    before = [p._version for p in ps]
    x = P.to_tensor(np.ones((2, 4), np.float32))
    out = (x @ ps[0]).sum()
    for p, g in zip(ps, GRADS[0]):
        p.grad = P.to_tensor(g)
    opt.step()
    assert [p._version for p in ps] == before
    out.backward()


@pytest.mark.parametrize("name", ["SGD", "Momentum", "Adam", "AdamW"])
def test_functional_update_is_the_references(name):
    """The pure form the jit train step takes: three updates of one
    parameter from its initial state."""
    import torch
    outs = {}
    for ns in (R, P):
        opt = build(ns, name, make_params(ns))
        param = FREE
        if ns is P:
            param = torch.from_numpy(param.copy())
        state = opt._init_functional_state(param)
        for step in range(3):
            g = GRADS[step][2]
            param, state = opt._functional_update(
                param, torch.from_numpy(g) if ns is P else g, state, 0.01)
        outs[ns] = (np.asarray(param), {k: np.asarray(v)
                                        for k, v in state.items()})
    close(outs[P][0], outs[R][0], name)
    assert outs[P][1].keys() == outs[R][1].keys()
    for k in outs[R][1]:
        close(outs[P][1][k], outs[R][1][k], f"{name} {k}")


def test_lbfgs_with_a_closure():
    a = np.random.RandomState(47).randn(6, 3).astype(np.float32)
    b = np.random.RandomState(48).randn(6).astype(np.float32)
    trails = {}
    for ns in (R, P):
        x = ns.to_tensor(np.zeros(3, np.float32), stop_gradient=False)
        opt = ns.optimizer.LBFGS(learning_rate=0.5, parameters=[x],
                                 history_size=3)
        A, B = ns.to_tensor(a), ns.to_tensor(b)

        def closure():
            opt.clear_grad()
            loss = ((A @ x - B) ** 2).sum()
            loss.backward()
            return loss
        losses = [float(opt.step(closure)) for _ in range(6)]
        assert losses[-1] < losses[0]
        trails[ns] = (losses, x.numpy())
    close(trails[P][0], trails[R][0], "losses")
    close(trails[P][1], trails[R][1], "x")


@pytest.mark.parametrize("ns", [R, P], ids=["reference", "port"])
def test_a_decay_that_is_not_a_float_reaches_the_missing_regularizer(ns):
    x = ns.to_tensor(np.ones(2, np.float32), stop_gradient=False)
    opt = ns.optimizer.SGD(0.1, [x], weight_decay=1)
    (x * x).sum().backward()
    with pytest.raises(ImportError):
        opt.step()


def test_minimize_runs_backward_only_where_none_ran():
    outs = {}
    for ns in (R, P):
        res = []
        for explicit in (False, True):
            x = ns.to_tensor(np.full(2, 2.0, np.float32), stop_gradient=False)
            opt = ns.optimizer.SGD(0.1, [x])
            loss = (x * x).sum()
            if explicit:
                loss.backward()
            assert opt.minimize(loss) == (None, None)
            res.append(x.numpy())
        np.testing.assert_allclose(res[0], res[1])
        np.testing.assert_allclose(res[0], np.full(2, 1.6), rtol=1e-6)
        outs[ns] = res
    close(outs[P], outs[R])


# ---- the schedulers ----

def schedulers(lr):
    return {
        "NoamDecay": lr.NoamDecay(64, 5, learning_rate=2.0),
        "PiecewiseDecay": lr.PiecewiseDecay([3, 8, 20], [1.0, 0.5, 0.1,
                                                         0.01]),
        "NaturalExpDecay": lr.NaturalExpDecay(0.5, 0.1),
        "InverseTimeDecay": lr.InverseTimeDecay(0.5, 0.2),
        "PolynomialDecay": lr.PolynomialDecay(0.5, 10, end_lr=0.01,
                                              power=2.0),
        "PolynomialDecay_cycle": lr.PolynomialDecay(0.5, 7, cycle=True),
        "LinearWarmup": lr.LinearWarmup(lr.CosineAnnealingDecay(0.3, 12), 4,
                                        0.0, 0.3),
        "LinearWarmup_float": lr.LinearWarmup(0.2, 6, 0.01, 0.2),
        "ExponentialDecay": lr.ExponentialDecay(0.5, 0.9),
        "MultiStepDecay": lr.MultiStepDecay(0.5, [4, 9, 15], 0.3),
        "StepDecay": lr.StepDecay(0.5, 4, 0.7),
        "LambdaDecay": lr.LambdaDecay(0.5, lambda e: 0.95 ** e),
        "MultiplicativeDecay": lr.MultiplicativeDecay(0.5, lambda e: 0.9),
        "CosineAnnealingDecay": lr.CosineAnnealingDecay(0.5, 10,
                                                        eta_min=0.01),
        "CosineAnnealingWarmRestarts": lr.CosineAnnealingWarmRestarts(
            0.5, 4, T_mult=2, eta_min=0.001),
        "OneCycleLR": lr.OneCycleLR(0.8, 25, three_phase=True),
        "OneCycleLR_linear": lr.OneCycleLR(0.8, 25, anneal_strategy="linear"),
        "CyclicLR": lr.CyclicLR(0.1, 0.9, 4, 6),
        "CyclicLR_triangular2": lr.CyclicLR(0.1, 0.9, 3, mode="triangular2"),
        "CyclicLR_exp_range": lr.CyclicLR(0.1, 0.9, 3, mode="exp_range",
                                          exp_gamma=0.95),
        "CyclicLR_scale_fn": lr.CyclicLR(0.1, 0.9, 3, scale_fn=lambda c:
                                         1.0 / (1 + c),
                                         scale_mode="iterations"),
    }


PLATEAU_LOSSES = [1.0, 0.9, 0.91, 0.92, 0.93, 0.95, 0.8, 0.8, 0.81, 0.82,
                  0.83, 0.84, 0.85, 0.7] * 3


@pytest.mark.parametrize("name", sorted(schedulers(P.optimizer.lr)))
def test_scheduler_sequence_is_the_references_exactly(name):
    seqs, states = {}, {}
    for ns in (R, P):
        s = schedulers(ns.optimizer.lr)[name]
        seq = []
        for _ in range(30):
            seq.append(s())
            s.step()
        seqs[ns], states[ns] = seq, s.state_dict()
    assert seqs[P] == seqs[R]
    assert states[P] == states[R]


@pytest.mark.parametrize("mode,threshold_mode", [("min", "rel"),
                                                 ("max", "abs")])
def test_reduce_on_plateau_is_the_references_exactly(mode, threshold_mode):
    seqs = {}
    for ns in (R, P):
        s = ns.optimizer.lr.ReduceOnPlateau(1.0, mode=mode, factor=0.5,
                                            patience=2, cooldown=1,
                                            threshold_mode=threshold_mode,
                                            min_lr=0.01)
        seq = []
        for loss in PLATEAU_LOSSES[:30]:
            seq.append(s())
            s.step(ns.to_tensor(np.float32(loss if mode == "min"
                                           else -loss)))
        seqs[ns] = seq
    assert seqs[P] == seqs[R]
    assert min(seqs[P]) < 1.0


def test_every_scheduler_has_a_sequence_case():
    names = {n.split("_")[0] for n in schedulers(P.optimizer.lr)} | \
        {"ReduceOnPlateau"}
    lr = P.optimizer.lr
    classes = {n for n in dir(lr) if isinstance(getattr(lr, n), type) and
               issubclass(getattr(lr, n), lr.LRScheduler) and
               n != "LRScheduler"}
    assert classes == names and len(classes) == 16
    assert math.isclose(P.optimizer.lr.NoamDecay(64, 5)(),
                        R.optimizer.lr.NoamDecay(64, 5)())
