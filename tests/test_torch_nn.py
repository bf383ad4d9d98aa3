"""Twins of `tests/test_nn.py` on the port's `nn` (`paddle_tpu_torch/nn/`),
each case run on both packages on the CPU (`case(ns)`) and the port held
to the reference.

Layers cross from the reference to the port through the numpy state dict
(`tests/torch_nn_cases.py::carry`), so outputs and gradients compare at
float32 2e-5 abs and rel.  `dropout_modes` is statistical (the packages'
draws differ), and `initializers_seeded` holds each package against
itself.  `save_load_roundtrip` runs in each package and then across
them: each loads the file the other wrote.
"""
import inspect

import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from torch_nn_cases import carry
from torch_op_test import on_cpu  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)


def rnd(*shape):
    return np.random.RandomState(7).rand(*shape).astype(np.float32)


def t(ns, a, sg=True):
    return ns.to_tensor(a, stop_gradient=sg)


def both(build):
    """(reference layer, port layer with the reference's weights)."""
    ref = build(R)
    return ref, carry(ref, build(P))


def close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL,
                               err_msg=what)


def grads_close(ref, port):
    rg = {n: p.grad for n, p in ref.named_parameters()}
    pg = {n: p.grad for n, p in port.named_parameters()}
    assert rg.keys() == pg.keys()
    for n in rg:
        assert (rg[n] is None) == (pg[n] is None), n
        if rg[n] is not None:
            close(pg[n].numpy(), rg[n].numpy(), n)


def _net(ns):
    class Net(ns.nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = ns.nn.Linear(4, 8)
            self.fc2 = ns.nn.Linear(8, 2)
            self.register_buffer("counter", ns.zeros([1]))

        def forward(self, x):
            return self.fc2(ns.nn.functional.relu(self.fc1(x)))
    return Net()


def test_layer_registration():
    ref, port = both(_net)
    for net in (ref, port):
        names = [n for n, _ in net.named_parameters()]
        assert names == ["fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"]
        sd = net.state_dict()
        assert "counter" in sd and len(sd) == 5
    assert list(port.state_dict()) == list(ref.state_dict())
    x = rnd(3, 4)
    out = port(t(P, x))
    assert out.shape == [3, 2]
    close(out.numpy(), ref(t(R, x)).numpy())


def test_state_dict_roundtrip():
    x = rnd(2, 4)
    for ns in (R, P):
        net1, net2 = ns.nn.Linear(4, 3), ns.nn.Linear(4, 3)
        net2.set_state_dict(net1.state_dict())
        np.testing.assert_array_equal(net1(t(ns, x)).numpy(),
                                      net2(t(ns, x)).numpy())
    ref, port = both(lambda ns: ns.nn.Linear(4, 3))
    close(port(t(P, x)).numpy(), ref(t(R, x)).numpy())


def test_save_load_roundtrip(tmp_path):
    x = rnd(2, 4)
    nets = {}
    for ns in (R, P):
        net = ns.nn.Linear(4, 3)
        path = str(tmp_path / f"{ns.__name__}.pdparams")
        ns.save(net.state_dict(), path)
        loaded = ns.load(path)
        net2 = ns.nn.Linear(4, 3)
        net2.set_state_dict(loaded)
        np.testing.assert_allclose(net(t(ns, x)).numpy(),
                                   net2(t(ns, x)).numpy())
        nets[ns] = (net, path)
    for ns, other in ((R, P), (P, R)):
        net, path = nets[other]
        twin = ns.nn.Linear(4, 3)
        twin.set_state_dict(ns.load(path))
        close(twin(t(ns, x)).numpy(), net(t(other, x)).numpy())


def test_softmax_cross_entropy():
    logits = rnd(4, 5) * 4
    labels = np.array([0, 2, 1, 4], np.int64)
    e = np.exp(logits - logits.max(-1, keepdims=True))
    p = e / e.sum(-1, keepdims=True)
    expect = -np.log(p[np.arange(4), labels]).mean()
    got = {}
    for ns in (R, P):
        got[ns] = ns.nn.functional.cross_entropy(t(ns, logits),
                                                 t(ns, labels)).numpy()
        np.testing.assert_allclose(got[ns], expect, rtol=1e-5)
    close(got[P], got[R])


def test_conv2d_matches_naive():
    x, w = rnd(1, 2, 5, 5), rnd(3, 2, 3, 3)
    xp = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)))
    expect = sum((xp[0, c, 1:4, 1:4] * w[0, c]).sum() for c in range(2))
    outs = {}
    for ns in (R, P):
        out = ns.nn.functional.conv2d(t(ns, x), t(ns, w), padding=1)
        assert out.shape == [1, 3, 5, 5]
        np.testing.assert_allclose(out.numpy()[0, 0, 1, 1], expect,
                                   rtol=1e-4)
        outs[ns] = out.numpy()
    close(outs[P], outs[R])


def test_batchnorm_train_eval():
    ref, port = both(lambda ns: ns.nn.BatchNorm2D(3))
    x = rnd(4, 3, 2, 2) * 5
    for net, ns in ((ref, R), (port, P)):
        net.train()
        y = net(t(ns, x))
        np.testing.assert_allclose(y.numpy().mean(axis=(0, 2, 3)),
                                   np.zeros(3), atol=1e-4)
        assert not np.allclose(net._mean.numpy(), np.zeros(3))
    close(port._mean.numpy(), ref._mean.numpy(), "running mean")
    close(port._variance.numpy(), ref._variance.numpy(), "running var")
    ref.eval(), port.eval()
    y2 = port(t(P, x))
    assert y2.shape == [4, 3, 2, 2]
    close(y2.numpy(), ref(t(R, x)).numpy())


def test_layernorm():
    ref, port = both(lambda ns: ns.nn.LayerNorm(8))
    x = rnd(2, 4, 8) * 3
    y = port(t(P, x)).numpy()
    np.testing.assert_allclose(y.mean(-1), np.zeros((2, 4)), atol=1e-5)
    np.testing.assert_allclose(y.std(-1), np.ones((2, 4)), atol=1e-2)
    close(y, ref(t(R, x)).numpy())


def test_embedding():
    ref, port = both(lambda ns: ns.nn.Embedding(10, 4))
    ids = np.array([[1, 2], [3, 9]], np.int64)
    for net, ns in ((ref, R), (port, P)):
        out = net(t(ns, ids))
        assert out.shape == [2, 2, 4]
        np.testing.assert_allclose(out.numpy()[0, 0], net.weight.numpy()[1])
        out.sum().backward()
        assert net.weight.grad is not None
    grads_close(ref, port)


def test_pooling():
    x = rnd(1, 1, 4, 4)
    outs = {}
    for ns in (R, P):
        F = ns.nn.functional
        out = F.max_pool2d(t(ns, x), 2)
        np.testing.assert_allclose(
            out.numpy(), x.reshape(1, 1, 2, 2, 2, 2).max((3, 5)))
        out2 = F.avg_pool2d(t(ns, x), 2)
        np.testing.assert_allclose(
            out2.numpy(), x.reshape(1, 1, 2, 2, 2, 2).mean((3, 5)),
            rtol=1e-6)
        outs[ns] = (out.numpy(), out2.numpy())
    for got, want in zip(outs[P], outs[R]):
        close(got, want)


def test_adaptive_pool():
    x = rnd(1, 2, 6, 6)
    outs = {}
    for ns in (R, P):
        out = ns.nn.functional.adaptive_avg_pool2d(t(ns, x), 2)
        assert out.shape == [1, 2, 2, 2]
        outs[ns] = out.numpy()
    close(outs[P], outs[R])


def test_dropout_modes():
    for ns in (R, P):
        x = t(ns, np.ones((100, 100), np.float32))
        y = ns.nn.functional.dropout(x, 0.5, training=True)
        kept = (y.numpy() != 0).mean()
        assert 0.4 < kept < 0.6
        np.testing.assert_allclose(y.numpy().mean(), 1.0, atol=0.05)
        y_eval = ns.nn.functional.dropout(x, 0.5, training=False)
        np.testing.assert_allclose(y_eval.numpy(), x.numpy())


def test_multihead_attention():
    ref, port = both(lambda ns: ns.nn.MultiHeadAttention(16, 4))
    x = rnd(2, 5, 16)
    outs = {}
    for net, ns in ((ref, R), (port, P)):
        out = net(t(ns, x), t(ns, x), t(ns, x))
        assert out.shape == [2, 5, 16]
        out.sum().backward()
        assert net.q_proj.weight.grad is not None
        outs[ns] = out.numpy()
    close(outs[P], outs[R])
    grads_close(ref, port)


def test_transformer_encoder():
    def build(ns):
        layer = ns.nn.TransformerEncoderLayer(16, 4, 32, dropout=0.0)
        return ns.nn.TransformerEncoder(layer, 2)
    ref, port = both(build)
    x = rnd(2, 5, 16)
    out = port(t(P, x))
    assert out.shape == [2, 5, 16]
    close(out.numpy(), ref(t(R, x)).numpy())


def test_lstm():
    ref, port = both(lambda ns: ns.nn.LSTM(4, 8, num_layers=1))
    x = rnd(2, 3, 4)
    outs = {}
    for net, ns in ((ref, R), (port, P)):
        out, (h, c) = net(t(ns, x))
        assert out.shape == [2, 3, 8]
        assert h.shape == [1, 2, 8]
        out.sum().backward()
        outs[ns] = (out.numpy(), h.numpy(), c.numpy())
    for got, want in zip(outs[P], outs[R]):
        close(got, want)
    grads_close(ref, port)


def test_sequential_containers():
    for ns in (R, P):
        seq = ns.nn.Sequential(ns.nn.Linear(4, 8), ns.nn.ReLU(),
                               ns.nn.Linear(8, 2))
        assert len(seq) == 3
        ll = ns.nn.LayerList([ns.nn.Linear(2, 2) for _ in range(3)])
        ll.append(ns.nn.Linear(2, 2))
        assert len(ll) == 4
        assert len(list(ll.parameters())) == 8
    ref, port = both(lambda ns: ns.nn.Sequential(
        ns.nn.Linear(4, 8), ns.nn.ReLU(), ns.nn.Linear(8, 2)))
    close(port(t(P, rnd(3, 4))).numpy(), ref(t(R, rnd(3, 4))).numpy())


def test_initializers_seeded():
    for ns in (R, P):
        ns.seed(123)
        l1 = ns.nn.Linear(16, 16)
        ns.seed(123)
        l2 = ns.nn.Linear(16, 16)
        np.testing.assert_allclose(l1.weight.numpy(), l2.weight.numpy())


def test_clip_grad_by_global_norm():
    outs = {}
    for ns in (R, P):
        p = t(ns, rnd(3, 3), sg=False)
        g = t(ns, np.full((3, 3), 10.0, np.float32))
        out = ns.nn.ClipGradByGlobalNorm(1.0)([(p, g)])
        assert out[0][0] is p and out[0][1].stop_gradient
        np.testing.assert_allclose(np.linalg.norm(out[0][1].numpy()), 1.0,
                                   rtol=1e-5)
        outs[ns] = out[0][1].numpy()
    close(outs[P], outs[R])


# ---- the namespaces ----

# the reference's nn names the port does not have yet, each with the
# ROADMAP Queue 1 item it waits for: none since item 13.3b
LEFT_OUT_NN = {}


def public_names(mod):
    """A namespace's public names that are not modules (nor the
    `annotations` feature a star import carries along)."""
    return {n for n in dir(mod) if not n.startswith("_") and
            n != "annotations" and not inspect.ismodule(getattr(mod, n))}


@pytest.mark.parametrize("path", ["nn", "nn.functional", "nn.layer"])
def test_nn_names_are_the_references_less_the_left_out(path):
    ref, port = R, P
    for part in path.split("."):
        ref, port = getattr(ref, part), getattr(port, part)
    want, got = public_names(ref), public_names(port)
    assert sorted(got - want) == []
    assert sorted(want - got) == sorted(n for n in LEFT_OUT_NN if n in want)


def test_every_left_out_nn_name_is_missing_somewhere():
    spaces = (R.nn, R.nn.functional, R.nn.layer)
    for n, item in LEFT_OUT_NN.items():
        assert item == "13.3b"
        assert any(hasattr(s, n) for s in spaces), n
        assert not any(hasattr(s, n) for s in (P.nn, P.nn.functional,
                                               P.nn.layer)), n
