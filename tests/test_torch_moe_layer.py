"""The port's MoE Layer files (`paddle_tpu_torch/incubate/distributed/models/
moe/`: `gate.py`, `moe_layer.py`, `grad_clip.py`) against the JAX
package's, on the CPU.

Weights cross through `tests/torch_nn_cases.py::carry`; outputs, aux
losses and gradients compare at float32 2e-5 abs and rel, routing indices
exactly (int32 in the reference, int64 in the port).  The two MoE cases of
`tests/test_hapi_moe.py` run in both packages and against each other (the
switch gate's training noise aside: each package draws its own, so that
twin runs the gate out of training and the draw is held each package
against itself).  `dispatch_and_combine` gives the reference's rows, its
drops included.  `ClipGradForMOEByGlobalNorm` clips expert and shared
grads together, and over a moe group of two ranks raises, naming the item
that brings the all-reduce.
"""
import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from torch_nn_cases import carry
from torch_op_test import on_cpu  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
_r = np.random.RandomState(41)


def f32(*shape):
    return _r.rand(*shape).astype(np.float32)


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL,
                               err_msg=what)


def moe_of(ns, d, n_experts, **kw):
    from_ns = ns.incubate.distributed.models.moe
    return from_ns.MoELayer(d_model=d, experts=[ns.nn.Linear(d, d) for _ in
                                                range(n_experts)], **kw)


def both(build):
    ref = build(R)
    return ref, carry(ref, build(P))


def grads(layer):
    return {n: None if p.grad is None else p.grad.numpy()
            for n, p in layer.named_parameters()}


def grads_close(ref, port):
    rg, pg = grads(ref), grads(port)
    assert rg.keys() == pg.keys()
    for n in rg:
        assert (rg[n] is None) == (pg[n] is None), n
        if rg[n] is not None:
            close(pg[n], rg[n], n)


def test_moe_layer_routes_and_learns():
    x0 = f32(16, 8)
    for ns in (R, P):
        ns.seed(0)
        moe = moe_of(ns, 8, 4, gate="switch")
        x = ns.to_tensor(x0, stop_gradient=False)
        out = moe(x)
        assert out.shape == [16, 8]
        aux = moe.gate.get_loss()
        assert aux is not None and moe.gate.get_loss() is None
        (out.sum() + aux * 0.01).backward()
        assert any(e.weight.grad is not None for e in moe.experts)
        assert moe.gate.gate_weight.grad is not None
    # the same, carried, with the gate's noise off: equal in both
    ref, port = both(lambda ns: moe_of(ns, 8, 4, gate="switch"))
    outs = {}
    for layer, ns in ((ref, R), (port, P)):
        layer.gate.eval()
        x = ns.to_tensor(x0, stop_gradient=False)
        out = layer(x)
        aux = layer.gate.get_loss()
        (out.sum() + aux * 0.01).backward()
        outs[ns] = (out.numpy(), float(aux), x.grad.numpy())
    for got, want in zip(outs[P], outs[R]):
        close(got, want)
    grads_close(ref, port)


def test_moe_capacity_drops_overflow():
    x0 = f32(32, 4)
    ref, port = both(lambda ns: moe_of(ns, 4, 2, gate="naive", topk=1,
                                       capacity_factor=0.5))
    outs = {}
    for layer, ns in ((ref, R), (port, P)):
        out = layer(ns.to_tensor(x0))
        assert out.shape == [32, 4]
        outs[ns] = out.numpy()
    close(outs[P], outs[R])
    # C = max(int(0.5 * 32 / 2), 4) = 8 slots an expert: 16 tokens kept
    dropped = (np.abs(outs[P]).sum(-1) == 0).sum()
    assert dropped == 32 - 2 * 8


def test_dispatch_and_combine():
    """The functional dispatch with a doubling expert: each kept
    assignment returns 2 x its token times its gate value."""
    x0 = f32(12, 4)
    idx = np.array([[0, 1], [1, 2]] * 6, np.int32)
    val = f32(12, 2)
    outs = {}
    for ns in (R, P):
        fn = ns.incubate.distributed.models.moe.moe_layer.dispatch_and_combine
        x = ns.to_tensor(x0)._t if ns is P else ns.to_tensor(x0)._data
        gi = ns.to_tensor(idx)._t if ns is P else ns.to_tensor(idx)._data
        gv = ns.to_tensor(val)._t if ns is P else ns.to_tensor(val)._data
        outs[ns] = np.asarray(fn(x, gi, gv, lambda buf: buf * 2, 3, 5))
    close(outs[P], outs[R])
    # expert 1 gets 12 assignments and keeps 5: rows past them lose it
    assert not np.allclose(outs[P], 2 * x0 * val.sum(-1, keepdims=True))


def gate_of(ns, kind):
    moe = ns.incubate.distributed.models.moe
    if kind == "naive":
        return moe.NaiveGate(6, 4, topk=2)
    if kind == "gshard":
        return moe.GShardGate(6, 4, topk=2)
    return moe.SwitchGate(6, 4)


@pytest.mark.parametrize("kind", ["naive", "gshard", "switch"])
def test_gate(kind):
    x0 = f32(10, 6)
    ref, port = both(lambda ns: gate_of(ns, kind))
    outs = {}
    for gate, ns in ((ref, R), (port, P)):
        gate.eval()
        x = ns.to_tensor(x0, stop_gradient=False)
        idx, val = gate(x)
        loss = gate.get_loss()
        total = (val * ns.arange(val.shape[-1]).astype("float32")).sum()
        if loss is not None:
            total = total + loss
        total.backward()
        outs[ns] = (idx.numpy(), val.numpy(), None if loss is None
                    else float(loss), x.grad.numpy())
    (pi, pv, pl, pg), (ri, rv, rl, rg) = outs[P], outs[R]
    assert (ri.dtype.name, pi.dtype.name) == ("int32", "int64")
    np.testing.assert_array_equal(pi, ri)
    close(pv, rv, "gate values")
    assert (pl is None) == (rl is None) == (kind == "naive")
    if rl is not None:
        close(pl, rl, "aux loss")
    close(pg, rg, "input grad")
    grads_close(ref, port)


@pytest.mark.parametrize("ns", [R, P], ids=["reference", "port"])
def test_switch_gate_training_noise_draws_under_the_seed(ns):
    x = ns.to_tensor(f32(64, 6))
    gate = gate_of(ns, "switch")
    gate.train()
    picks = []
    for seed in (5, 5, 6):
        ns.seed(seed)
        idx, val = gate(x)
        picks.append(val.numpy())
    np.testing.assert_array_equal(picks[0], picks[1])
    assert not np.array_equal(picks[0], picks[2])
    gate.eval()
    np.testing.assert_array_equal(gate(x)[1].numpy(), gate(x)[1].numpy())


def _clip_run(ns, clip_norm):
    moe = ns.incubate.distributed.models.moe
    ps = [ns.to_tensor(f, stop_gradient=False) for f in CLIP_PARAMS]
    for p, expert in zip(ps, (True, False, True, False)):
        p.is_expert = expert
    gs = [ns.to_tensor(g) for g in CLIP_GRADS] + [None]
    pairs = list(zip(ps + [ps[0]], gs))
    return moe.ClipGradForMOEByGlobalNorm(clip_norm)(pairs)


CLIP_PARAMS = [np.zeros((3, 2), np.float32)] * 4
CLIP_GRADS = [np.random.RandomState(s).randn(3, 2).astype(np.float32) * 3
              for s in range(4)]


@pytest.mark.parametrize("clip_norm", [1.0, 100.0])
def test_moe_global_norm_clip(clip_norm):
    got, want = _clip_run(P, clip_norm), _clip_run(R, clip_norm)
    assert len(got) == len(want) == 5
    assert got[-1][1] is None and want[-1][1] is None
    for (_, g), (_, w) in zip(got[:-1], want[:-1]):
        assert g.stop_gradient
        close(g.numpy(), w.numpy())
    total = np.sqrt(sum((g ** 2).sum() for g in CLIP_GRADS))
    scale = clip_norm / max(total, clip_norm)
    close(got[0][1].numpy(), CLIP_GRADS[0] * scale, "against numpy")


def test_moe_clip_over_a_group_of_two_ranks_raises():
    class Group:
        nranks = 2
    moe = P.incubate.distributed.models.moe
    clip = moe.ClipGradForMOEByGlobalNorm(1.0, moe_group=Group())
    p = P.to_tensor(np.zeros(2, np.float32), stop_gradient=False)
    with pytest.raises(NotImplementedError, match="eager distributed/"):
        clip([(p, P.to_tensor(np.ones(2, np.float32)))])
    # one rank needs no all-reduce
    Group.nranks = 1
    out = clip([(p, P.to_tensor(np.ones(2, np.float32)))])
    close(out[0][1].numpy(), np.ones(2) / np.sqrt(2))
