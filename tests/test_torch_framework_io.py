"""The port's `paddle.save`/`paddle.load` and `paddle.framework`
(`paddle_tpu_torch/framework/`) against the JAX package's, on the CPU.

- float32 files cross both ways: a `Linear`'s state dict, an `AdamW`'s (its
  moments, `LR_Scheduler` and `global_step`) after a step, and a
  `GradScaler`'s, each written by one package and loaded by the other,
  bit for bit; the loaded optimizer state carries on in the other package
  (one more step, within float32 2e-5).
- bfloat16: a JAX-package file (an `ml_dtypes` array) loads into the port
  by its bits; the port's own bf16 files (the `{"__bfloat16_bits__": ...}`
  form) restore bit for bit, and read as a dict in the JAX package.
- `return_numpy`, file objects, nested lists and tuples, and the
  `framework` namespace (its names are the reference's; `core` answers for
  this build).
- A `TransformerEncoder`'s copies take parameter names of their own in the
  port (the reference's share the first layer's), so a saved `AdamW`
  state restores every parameter's moments.
"""
import io

import numpy as np
import pytest
import torch

import paddle_tpu as R
import paddle_tpu_torch as P
from torch_nn_cases import carry
from torch_op_test import on_cpu  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)


def rnd(*s, seed=3):
    return np.random.RandomState(seed).randn(*s).astype(np.float32)


def linear_pair():
    R.seed(0)
    ref = R.nn.Linear(4, 3)
    return ref, carry(ref, P.nn.Linear(4, 3))


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_linears_state_crosses_both_ways(tmp_path, writer):
    ref, port = linear_pair()
    src, dst, dst_ns = (ref, port, P) if writer == "ref" else (port, ref, R)
    src_ns = R if writer == "ref" else P
    with torch.no_grad():
        src.weight.set_value(rnd(4, 3, seed=9))     # differ from dst first
    path = tmp_path / "linear.pdparams"
    src_ns.save(src.state_dict(), str(path))
    loaded = dst_ns.load(str(path))
    assert sorted(loaded) == ["bias", "weight"]
    for k, v in loaded.items():
        assert v.dtype.name == "float32" and v.persistable
        np.testing.assert_array_equal(v.numpy(), src.state_dict()[k].numpy())
    dst.set_state_dict(loaded)
    x = rnd(2, 4)
    np.testing.assert_array_equal(dst(dst_ns.to_tensor(x)).numpy(),
                                  src(src_ns.to_tensor(x)).numpy())


def adamw_step(ns, lin, opt, x):
    loss = (lin(ns.to_tensor(x)) ** 2).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()


def adamw(ns, lin):
    sched = ns.optimizer.lr.CosineAnnealingDecay(1e-2, T_max=4)
    return ns.optimizer.AdamW(learning_rate=sched, weight_decay=0.01,
                              parameters=lin.parameters()), sched


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_an_adamws_state_crosses_both_ways_and_carries_on(tmp_path, writer):
    """One step in the writer, its state saved and loaded into the other
    package's optimizer (the parameters given the writer's names, since
    both packages key moments by a process-wide name counter), then one
    more step in each: the same parameters."""
    ref, port = linear_pair()
    x = rnd(5, 4)
    ro, rs = adamw(R, ref)
    po, ps = adamw(P, port)
    for ns, lin, opt, sched in ((R, ref, ro, rs), (P, port, po, ps)):
        adamw_step(ns, lin, opt, x)
        sched.step()
    src_ns, src, dst_ns, dst, dst_opt = (R, ro, P, port, po) if \
        writer == "ref" else (P, po, R, ref, ro)
    path = tmp_path / "opt.pdopt"
    src_ns.save(src.state_dict(), str(path))
    loaded = dst_ns.load(str(path))
    want = src.state_dict()
    assert sorted(loaded) == sorted(want)
    assert loaded["global_step"] == 1
    assert loaded["LR_Scheduler"] == want["LR_Scheduler"]
    for k, v in want.items():
        if k not in ("global_step", "LR_Scheduler"):
            np.testing.assert_array_equal(loaded[k].numpy(), v.numpy(), k)
    src_lin = ref if writer == "ref" else port
    for d, s in zip(dst.parameters(), src_lin.parameters()):
        d.name = s.name
    dst_opt._accumulators.clear()
    dst_opt.set_state_dict(loaded)
    for ns, lin, opt in ((R, ref, ro), (P, port, po)):
        adamw_step(ns, lin, opt, x)
    for a, b in zip(port.parameters(), ref.parameters()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_grad_scalers_state_crosses_both_ways(tmp_path, writer):
    src_ns, dst_ns = (R, P) if writer == "ref" else (P, R)
    s = src_ns.amp.GradScaler(init_loss_scaling=256.0)
    s._found_inf = True
    s.update()
    s.update()
    buf = io.BytesIO()
    src_ns.save(s.state_dict(), buf)
    buf.seek(0)
    t = dst_ns.amp.GradScaler()
    t.load_state_dict(dst_ns.load(buf))
    assert t.state_dict() == s.state_dict()
    assert t.get_loss_scaling() == 128.0


def bits(a):
    return np.asarray(a).view(np.uint16)


def test_a_reference_bf16_file_loads_into_the_port_by_its_bits(tmp_path):
    x = R.to_tensor(rnd(3, 5) * 100).astype("bfloat16")
    path = tmp_path / "bf16.pd"
    R.save({"w": x, "n": 7}, str(path))
    got = P.load(str(path))
    assert got["n"] == 7 and got["w"].dtype == P.bfloat16
    want = bits(np.asarray(R.load(str(path), return_numpy=True)["w"]))
    np.testing.assert_array_equal(
        got["w"]._t.view(torch.int16).numpy().view(np.uint16), want)


def test_the_ports_bf16_round_trip_is_bitwise(tmp_path):
    t = torch.from_numpy(rnd(4, 6) * 1e3).to(torch.bfloat16)
    t[0, 0] = float("inf")
    t[0, 1] = float("-0.0")
    x = P.to_tensor(t)
    path = tmp_path / "bf16_port.pd"
    P.save({"w": x, "pair": (x, [1, "a"])}, str(path))
    got = P.load(str(path))
    for v in (got["w"], got["pair"][0]):
        assert v.dtype == P.bfloat16 and v.persistable
        assert torch.equal(v._t.view(torch.int16), t.view(torch.int16))
    assert got["pair"][1] == [1, "a"] and isinstance(got["pair"], tuple)
    as_np = P.load(str(path), return_numpy=True)["w"]
    assert as_np.dtype == np.float32
    np.testing.assert_array_equal(as_np, t.float().numpy())
    # the JAX package reads the port's bf16 form as the dict it is
    raw = R.load(str(path), return_numpy=True)["w"]
    assert sorted(raw) == ["__bfloat16_bits__"]
    np.testing.assert_array_equal(raw["__bfloat16_bits__"],
                                  t.view(torch.int16).numpy().view(np.uint16))


@pytest.mark.parametrize("dtype", ["float32", "float16", "int32", "bool"])
def test_plain_dtypes_load_in_both_packages(tmp_path, dtype):
    a = (rnd(3, 4) * 10).astype(dtype)
    for src, dst in ((R, P), (P, R)):
        path = tmp_path / f"{src.__name__}.pd"
        src.save([src.to_tensor(a)], str(path))
        got = dst.load(str(path))
        assert isinstance(got, list) and got[0].dtype.name == dtype
        np.testing.assert_array_equal(got[0].numpy(), a)
        got_np = dst.load(str(path), return_numpy=True)[0]
        assert isinstance(got_np, np.ndarray)
        np.testing.assert_array_equal(got_np, a)


def test_file_objects_and_nested_state():
    state = {"a": P.to_tensor(rnd(2, 2)), "b": [P.to_tensor(np.arange(3)),
                                               {"c": 1.5}], "d": (2, None)}
    buf = io.BytesIO()
    P.save(state, buf)
    buf.seek(0)
    got = P.load(buf)
    np.testing.assert_array_equal(got["a"].numpy(), state["a"].numpy())
    np.testing.assert_array_equal(got["b"][0].numpy(), np.arange(3))
    assert got["b"][1] == {"c": 1.5} and got["d"] == (2, None)
    assert got["a"].stop_gradient and got["a"].place == P.CPUPlace()
    buf.seek(0)
    ref = R.load(buf)
    np.testing.assert_array_equal(ref["a"].numpy(), state["a"].numpy())


def test_a_legacy_marker_file_loads_in_both(tmp_path):
    import pickle
    path = tmp_path / "legacy.pd"
    with open(path, "wb") as f:
        pickle.dump({"x": {"__ptensor__": True, "data": rnd(2, 3),
                           "stop_gradient": False, "name": "w0"}}, f)
    for ns in (R, P):
        t = ns.load(str(path))["x"]
        assert t.name == "w0" and not t.stop_gradient and t.persistable
        np.testing.assert_array_equal(t.numpy(), rnd(2, 3))


def test_framework_namespace_is_the_references():
    def names(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and n != "annotations"}
    assert names(P.framework) == names(R.framework)
    assert P.framework.save is P.save and P.framework.load is P.load
    assert P.framework.Parameter is P.core.tensor.Parameter
    assert P.framework.in_dygraph_mode() and P.framework.in_dynamic_mode()
    assert not P.framework.in_pir_mode() and not P.framework.use_pir_api()
    core = P.framework.core
    assert core.is_compiled_with_cuda() == torch.backends.cuda.is_built()
    assert not core.is_compiled_with_xpu()
    assert core.eager_tensor is P.Tensor
    core.nvprof_nvtx_push("x")
    core.nvprof_nvtx_pop()
    P.framework.seed(5)
    state = P.framework.get_rng_state()
    a = P.rand([3]).numpy()
    P.framework.set_rng_state(state)
    np.testing.assert_array_equal(P.rand([3]).numpy(), a)


def test_an_encoders_optimizer_state_keeps_every_layers_moments(tmp_path):
    """The reference's `TransformerEncoder` deep-copies its layer and the
    copies keep the first layer's parameter names, so an optimizer's state
    dict (keyed by name) keeps one layer's moments for all; the port names
    each copy's parameters anew, and a saved `AdamW` state restores every
    parameter's moments."""
    counts = {}
    for ns in (R, P):
        enc = ns.nn.TransformerEncoder(ns.nn.TransformerEncoderLayer(
            8, 2, 16, dropout=0.0), 3)
        names = [p.name for p in enc.parameters()]
        counts[ns] = (len(names), len(set(names)))
    assert counts[R] == (48, 16) and counts[P] == (48, 48)
    params = list(enc.parameters())
    opt = P.optimizer.AdamW(learning_rate=1e-2, parameters=params)
    enc(P.to_tensor(rnd(2, 3, 8))).sum().backward()
    opt.step()
    path = str(tmp_path / "enc.pdopt")
    P.save(opt.state_dict(), path)
    fresh = P.optimizer.AdamW(learning_rate=1e-2, parameters=params)
    fresh.set_state_dict(P.load(path))
    for name in ("moment1", "moment2", "beta1_pow", "beta2_pow"):
        for p in params:
            assert torch.equal(fresh._accumulators[name][id(p)],
                               opt._accumulators[name][id(p)]), (name, p.name)
