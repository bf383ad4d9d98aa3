"""The port's Layer API (`nn/layer/layers.py`, `nn/initializer`,
`param_attr.py`, `models/gpt.py::GPTForCausalLM`) against the JAX
package's, on the CPU.

- `Layer`: the same small tree built in both packages: parameters, buffers,
  sublayers, forward hooks, `state_dict`/`set_state_dict`, casts, and the
  gradients of one backward (rtol 1e-6).
- `create_parameter` with `ParamAttr` and the deterministic initializers
  exact against the reference; the random ones (the port's own stream) for
  shape, dtype, determinism per seed and moments within 5 standard errors.
- `GPTForCausalLM` on `gpt_tiny` and `llama_tiny` (float32), the
  reference model's weights carried over by `set_state_dict` (its
  `state_dict()` as numpy) and by `load_pytree(params_from_numpy(...))`:
  logits, loss and every parameter's gradient within atol=rtol=1e-4 (the
  `tests/test_torch_model.py` tolerance), the state-dict keys in the
  reference's order, greedy `generate` token for token (a divergence passes
  only at a reported top-2 near-tie, margin below 1e-4), and a twin of
  `tests/test_generation_llama.py::test_generate_layer_api_and_sampling`.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as R
import paddle_tpu_torch as P
from paddle_tpu.core.tensor import apply as rapply
from paddle_tpu.models import gpt as G
from paddle_tpu_torch.core import place as place_mod
from paddle_tpu_torch.core.tensor import apply as papply
from paddle_tpu_torch.models import gpt as TG
from paddle_tpu_torch.models.convert import params_from_numpy
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-4, rtol=1e-4)
TIE_MARGIN = 1e-4


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = place_mod._expected_place
    P.set_device("cpu")
    yield
    place_mod._expected_place = prev


def psum(y):
    return papply("sum", torch.sum, y)


def rsum(y):
    return rapply("sum", jnp.sum, y)


# ---- Layer ----

ASSIGN = np.arange(6, dtype=np.float32).reshape(3, 2) / 4


def build(pkg):
    """The same Layer tree in either package."""
    nn, init = pkg.nn, pkg.nn.initializer

    class Block(nn.Layer):
        def __init__(self, scale):
            super().__init__()
            self.w = self.create_parameter(
                [4, 3], default_initializer=init.Constant(scale))
            self.b = self.create_parameter([3], is_bias=True)
            self.register_buffer("steps", pkg.to_tensor(
                np.zeros([1], np.float32)))
            self.register_buffer("scratch", pkg.to_tensor(
                np.ones([2], np.float32)), persistable=False)

        def forward(self, x):
            return x @ self.w + self.b

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.a = Block(0.5)
            self.c = Block(-0.25)
            self.head = self.create_parameter([3, 2], attr=pkg.ParamAttr(
                name="head_w", initializer=init.Assign(ASSIGN)))
            self.frozen = self.create_parameter([2], attr=pkg.ParamAttr(
                initializer=init.Constant(1.0), trainable=False))
            self.none = self.create_parameter([2], attr=False)

        def forward(self, x):
            return (self.a(x) * self.c(x)) @ self.head + self.frozen

    return Net()


X = np.random.RandomState(0).randn(5, 4).astype(np.float32)


def test_layer_structure_matches_the_reference():
    r, p = build(R), build(P)
    assert p.none is None and r.none is None
    for fn in ("named_parameters", "named_buffers", "named_sublayers"):
        assert [n for n, _ in getattr(p, fn)()] == \
            [n for n, _ in getattr(r, fn)()], fn
    assert list(p.state_dict()) == list(r.state_dict())
    assert "a.scratch" not in p.state_dict()
    for (n, pt), (_, rt) in zip(p.state_dict().items(),
                                r.state_dict().items()):
        assert pt.shape == rt.shape and pt.dtype.name == rt.dtype.name, n
        np.testing.assert_array_equal(pt.numpy(), np.asarray(rt.numpy()))
    assert p.head.name == r.head.name == "head_w"
    assert p.frozen.stop_gradient and not p.frozen.trainable
    assert [type(s).__name__ for s in p.children()] == ["Block", "Block"]
    assert p.full_name().startswith("net_")
    assert p.a.w.persistable and isinstance(p.a.w, P.Tensor)
    assert "a" in dir(p) and "head" in dir(p)
    seen = []
    p.apply(lambda layer: seen.append(type(layer).__name__))
    assert seen == ["Block", "Block", "Net"]
    p.eval()
    assert not p.training and not p.a.training
    p.train()
    assert p.c.training
    del p.c
    assert [n for n, _ in p.named_sublayers()] == ["a"]
    with pytest.raises(AttributeError):
        p.c


def test_layer_forward_backward_and_hooks_match_the_reference():
    got = {}
    for pkg, sm in ((R, rsum), (P, psum)):
        net = build(pkg)
        calls = []
        pre = net.register_forward_pre_hook(
            lambda layer, inputs: (inputs[0] * 2.0,))
        post = net.a.register_forward_post_hook(
            lambda layer, inputs, out: calls.append("a") or out + 1.0)
        out = net(pkg.to_tensor(X))
        loss = sm(out * out)
        loss.backward()
        res = {"out": out.numpy(), "loss": loss.numpy()}
        for n, prm in net.named_parameters():
            res[n] = None if prm.grad is None else prm.grad.numpy()
        pre.remove()
        post.remove()
        res["plain"] = net(pkg.to_tensor(X)).numpy()
        assert calls == ["a"]
        net.clear_gradients()
        assert all(prm.grad is None for prm in net.parameters())
        got[pkg.__name__] = res
    want, port = got["paddle_tpu"], got["paddle_tpu_torch"]
    assert port["frozen"] is None
    for k, v in want.items():
        if v is None:
            assert port[k] is None, k
        else:
            np.testing.assert_allclose(port[k], np.asarray(v), rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_set_state_dict_and_casts():
    r, p = build(R), build(P)
    sd = {k: np.asarray(v.numpy()) * 3 for k, v in r.state_dict().items()}
    sd["extra"] = np.zeros(1, np.float32)
    del sd["head"]
    for net in (r, p):
        missing, unexpected = net.set_state_dict(sd)
        assert missing == ["head"] and unexpected == ["extra"]
    for k in sd:
        if k != "extra":
            np.testing.assert_array_equal(p.state_dict()[k].numpy(),
                                          np.asarray(r.state_dict()[k].numpy()))
    with pytest.raises(ValueError, match="shape mismatch"):
        p.set_state_dict({"a.w": np.zeros((3, 3), np.float32)})
    # a leaf stays a leaf and keeps its grad through a load
    out = psum(p(P.to_tensor(X)))
    out.backward()
    grad = p.a.w.grad.numpy()
    p.set_state_dict({"a.w": P.to_tensor(np.ones((4, 3), np.float32))})
    assert p.a.w.is_leaf and not p.a.w.stop_gradient
    np.testing.assert_array_equal(p.a.w.grad.numpy(), grad)
    p.half()
    assert all(t.dtype == P.float16 for t in p.parameters() + p.buffers())
    assert not p.a.w.stop_gradient and p.a.w.grad.dtype == P.float16
    p.bfloat16()
    assert p.a.b.dtype == P.bfloat16
    p.to(device="cpu", dtype="float32")
    assert p.head.dtype == P.float32 and p.head.place == P.CPUPlace()
    p.a.steps = np.float32([5.0])           # a buffer takes a value
    np.testing.assert_array_equal(p.a.steps.numpy(), [5.0])


# ---- initializers ----

def test_deterministic_initializers_match_the_reference():
    for name, args, shape in (("Constant", (0.75,), [3, 4]),
                              ("Assign", (ASSIGN,), [3, 2]),
                              ("Dirac", (), [4, 2, 3, 3]),
                              ("Bilinear", (), [2, 2, 4, 4])):
        vals = []
        for pkg in (R, P):
            layer = pkg.nn.Layer()
            prm = layer.create_parameter(shape, default_initializer=getattr(
                pkg.nn.initializer, name)(*args))
            vals.append(np.asarray(prm.numpy()))
        np.testing.assert_array_equal(vals[1], vals[0], err_msg=name)
    for nl in ("sigmoid", "tanh", "relu", "leaky_relu", "selu", "conv2d"):
        assert P.nn.initializer.calculate_gain(nl) == \
            R.nn.initializer.calculate_gain(nl)
    assert P.nn.initializer.calculate_gain("leaky_relu", 0.2) == \
        R.nn.initializer.calculate_gain("leaky_relu", 0.2)


def _trunc_var(a, b):
    phi = lambda x: math.exp(-x * x / 2) / math.sqrt(2 * math.pi)  # noqa
    cdf = lambda x: 0.5 * (1 + math.erf(x / math.sqrt(2)))  # noqa
    z = cdf(b) - cdf(a)
    return 1 + (a * phi(a) - b * phi(b)) / z - ((phi(a) - phi(b)) / z) ** 2


SHAPE = (256, 128)          # fans (256, 128)
RANDOM = {  # name: (args, mean, variance)
    "Uniform": ((-1.0, 3.0), 1.0, 16 / 12),
    "Normal": ((0.5, 2.0), 0.5, 4.0),
    "TruncatedNormal": ((0.0, 1.0, -2.0, 2.0), 0.0, _trunc_var(-2.0, 2.0)),
    "XavierUniform": ((), 0.0, 6.0 / 384 / 3),
    "XavierNormal": ((), 0.0, 2.0 / 384),
    "KaimingUniform": ((), 0.0, 2.0 / 256),
    "KaimingNormal": ((), 0.0, 2.0 / 256),
}


@pytest.mark.parametrize("name", list(RANDOM))
def test_random_initializers_shape_dtype_seed_and_moments(name):
    args, mean, var = RANDOM[name]
    init = getattr(P.nn.initializer, name)

    def make(dtype="float32"):
        return P.nn.Layer().create_parameter(list(SHAPE), dtype=dtype,
                                             default_initializer=init(*args))
    P.seed(21)
    a = make()
    b = make()
    P.seed(21)
    again = make()
    assert a.shape == list(SHAPE) and a.dtype == P.float32
    np.testing.assert_array_equal(again.numpy(), a.numpy())
    assert not np.array_equal(a.numpy(), b.numpy())
    assert make("bfloat16").dtype == P.bfloat16
    v = a.numpy().astype(np.float64).ravel()
    n = v.size
    assert abs(v.mean() - mean) < 5 * math.sqrt(var / n), (v.mean(), mean)
    assert abs(v.var() - var) < 5 * var * math.sqrt(2 / n), (v.var(), var)
    if name == "TruncatedNormal":
        assert v.min() >= -2.0 and v.max() <= 2.0


def test_orthogonal_initializer():
    P.seed(4)
    w = P.nn.Layer().create_parameter(
        [8, 16], default_initializer=P.nn.initializer.Orthogonal(gain=2.0))
    m = w.numpy()
    np.testing.assert_allclose(m @ m.T, 4 * np.eye(8), atol=1e-5)


# ---- GPTForCausalLM ----

PRESETS = {"gpt_tiny": (G.gpt_tiny, TG.gpt_tiny),
           "llama_tiny": (G.llama_tiny, TG.llama_tiny)}


@pytest.fixture(scope="module", params=list(PRESETS))
def models(request):
    """(reference model, port model loaded by set_state_dict, port model
    loaded by load_pytree), at seq 64."""
    jp, tp = PRESETS[request.param]
    R.seed(0)
    ref = G.GPTForCausalLM(jp(64))
    by_sd = TG.GPTForCausalLM(tp(64))
    by_sd.set_state_dict({k: np.asarray(v.numpy())
                          for k, v in ref.state_dict().items()})
    by_tree = TG.GPTForCausalLM(tp(64))
    tree = jax.tree_util.tree_map(np.asarray, ref.params_pytree())
    by_tree.load_pytree(params_from_numpy(tree, tp(64), "cpu"))
    return ref, by_sd, by_tree


def batch(cfg, B=2, S=32, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(ids, -1, 1).astype(np.int32)
    labels[:, -1] = -100
    return ids, labels


def test_state_dict_keys_follow_the_reference_flatten_order(models):
    ref, port, by_tree = models
    assert list(port.state_dict()) == list(ref.state_dict())
    flat = jax.tree_util.tree_flatten_with_path(ref.params_pytree())[0]
    names = ["/".join(k.key for k in path) for path, _ in flat]
    assert ["/".join(p) for p in port._paths] == names
    for (k, pv), (_, rv), (_, tv) in zip(port.state_dict().items(),
                                         ref.state_dict().items(),
                                         by_tree.state_dict().items()):
        assert pv.shape == rv.shape, k
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv.numpy()))
        np.testing.assert_array_equal(tv.numpy(), pv.numpy())
    assert all(not p.stop_gradient and p.is_leaf for p in port.parameters())
    tree = port.params_pytree()
    for path, p in zip(port._paths, port.parameters()):
        node = tree
        for k in path:
            node = node[k]
        assert node is p._t


def test_logits_and_loss_match_the_reference(models):
    ref, port, by_tree = models
    ids, labels = batch(port.config)
    want = np.asarray(ref(R.to_tensor(ids)).numpy())
    for m in (port, by_tree):
        logits = m(P.to_tensor(ids))
        assert logits.shape == list(want.shape)
        np.testing.assert_allclose(logits.numpy(), want, **TOL)
    np.testing.assert_allclose(port(ids).numpy(), want, **TOL)   # numpy in
    wl = float(ref(R.to_tensor(ids), R.to_tensor(labels)))
    gl = float(port(P.to_tensor(ids), P.to_tensor(labels)))
    np.testing.assert_allclose(gl, wl, **TOL)


def test_every_parameter_grad_matches_the_reference(models):
    ref, port, _ = models
    ids, labels = batch(port.config, seed=1)
    ref.clear_gradients()
    port.clear_gradients()
    ref(R.to_tensor(ids), R.to_tensor(labels)).backward()
    loss = port(P.to_tensor(ids), P.to_tensor(labels))
    loss.backward()
    unused = []
    for (k, pp), (_, rp) in zip(port.named_parameters(),
                                ref.named_parameters()):
        want = np.asarray(rp.grad.numpy())
        if pp.grad is None:
            # a leaf the loss does not read (the llama presets' norm
            # biases): no grad in the port, zeros from the reference's
            # whole-model vjp
            assert not want.any(), k
            unused.append("/".join(port._paths[int(k[1:])]))
            continue
        np.testing.assert_allclose(pp.grad.numpy(), want, err_msg=k, **TOL)
    assert unused == ([] if port.config.use_bias else
                      ["blocks/ln1_b", "blocks/ln2_b", "lnf_b"])
    # the same tensors through the functional loss: autograd.grad agrees
    leaves = [p._t for p in port.parameters()]
    fl = TG.loss_fn(port.params_pytree(), torch.as_tensor(ids),
                    torch.as_tensor(labels), port.config)
    for p, gr in zip(port.parameters(), torch.autograd.grad(
            fl, leaves, allow_unused=True)):
        assert (p.grad is None) == (gr is None)
        if gr is not None:
            np.testing.assert_array_equal(p.grad.numpy(), gr.numpy())
    port.clear_gradients()


def test_greedy_generate_matches_the_reference(models):
    ref, port, _ = models
    ids, _ = batch(port.config, B=3, S=8, seed=2)
    want = np.asarray(ref.generate(R.to_tensor(ids),
                                   max_new_tokens=12).numpy())
    got = port.generate(P.to_tensor(ids), max_new_tokens=12)
    assert got.shape == [3, 20] and got.dtype == P.int32
    got = got.numpy()
    for b in range(3):
        diff = np.nonzero(got[b] != want[b])[0]
        if len(diff):                   # only at a near-tie
            i = int(diff[0])
            logits = np.asarray(ref(R.to_tensor(want[b:b + 1, :i])).numpy()
                                )[0, -1]
            top2 = np.sort(logits)[-2:]
            margin = float(top2[1] - top2[0])
            print(f"row {b}: diverges at {i} (top-2 margin {margin})")
            assert margin < TIE_MARGIN


def test_generate_layer_api_and_sampling():
    """Twin of tests/test_generation_llama.py's case: both packages'
    models of gpt_tiny(64) give [1, 8] greedy and sampled outputs within
    the vocabulary; with the reference's weights the greedy ones agree."""
    R.seed(1)
    rm = G.GPTForCausalLM(G.gpt_tiny(64))
    pm = TG.GPTForCausalLM(TG.gpt_tiny(64))
    prompt = np.zeros((1, 3), np.int32)
    for model, pkg in ((rm, R), (pm, P)):
        out = model.generate(pkg.to_tensor(prompt), max_new_tokens=5)
        assert out.shape == [1, 8]
        s = model.generate(pkg.to_tensor(prompt), max_new_tokens=5,
                           temperature=0.9, top_k=8)
        assert s.shape == [1, 8] and (np.asarray(s.numpy()) < 256).all()
    pm.set_state_dict({k: np.asarray(v.numpy())
                       for k, v in rm.state_dict().items()})
    np.testing.assert_array_equal(
        pm.generate(P.to_tensor(prompt), max_new_tokens=5).numpy(),
        np.asarray(rm.generate(R.to_tensor(prompt), max_new_tokens=5).numpy()))


def test_bfloat16_state_dict_loads_by_its_bits():
    """A bf16 reference state dict (ml_dtypes arrays) lands bit-exact in a
    bf16 port model."""
    R.seed(2)
    ref = G.GPTForCausalLM(G.llama_tiny(32))
    cfg = TG.llama_tiny(32)
    cfg.dtype = torch.bfloat16
    port = TG.GPTForCausalLM(cfg)
    sd = {k: np.asarray(v.numpy()).astype(jnp.bfloat16)
          for k, v in ref.state_dict().items()}
    port.set_state_dict(sd)
    for k, v in port.state_dict().items():
        assert v.dtype == P.bfloat16
        np.testing.assert_array_equal(v.numpy(), sd[k].astype(np.float32))


def test_load_pytree_rejects_wrong_shapes():
    m = TG.GPTForCausalLM(TG.gpt_tiny(32))
    tree = m.params_pytree()
    tree["wte"] = tree["wte"][:, :-1]
    with pytest.raises(ValueError, match="wte"):
        m.load_pytree(tree)
