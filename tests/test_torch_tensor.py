"""The port's eager core (`core/dtype.py`, `place.py`, `flags.py`,
`generator.py`, `tensor.py`) against the JAX package's, on the CPU.

The same numpy-seeded values go through `paddle_tpu` and
`paddle_tpu_torch` (`set_device("cpu")`): dtype names and `to_tensor`'s
rules, places, flags and the NaN/Inf check, every dunder and indexing form
(exact for integers, rtol 1e-6 for floats) and the in-place ops.  The
generator's numbers are the port's own (torch's, not threefry's): it is
held to determinism per seed, its state round trip and the tracker.

Where the reference runs JAX with 64-bit types off, its int64 and float64
data arrive as 32-bit; the port keeps 64 bits (`core/tensor.py`), so those
cases check the port's rule alone.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as R
import paddle_tpu_torch as P
from paddle_tpu_torch.core import generator as gen
from paddle_tpu_torch.core import place as place_mod
from paddle_tpu_torch.core.tensor import apply
from paddle_tpu_torch.nn import initializer as I
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def on_cpu():
    prev = place_mod._expected_place
    P.set_device("cpu")
    yield
    place_mod._expected_place = prev


def same(got, want):
    """Port result against the reference's: equal dtype names, values exact
    for integers and bools, rtol 1e-6 for floats."""
    got_a, want_a = np.asarray(got.numpy()), np.asarray(want.numpy())
    assert got.dtype.name == want.dtype.name, (got.dtype, want.dtype)
    assert got.shape == list(want.shape)
    if np.issubdtype(want_a.dtype, np.floating):
        np.testing.assert_allclose(got_a, want_a, rtol=RTOL, atol=0)
    else:
        np.testing.assert_array_equal(got_a, want_a)


def pair(a, **kw):
    return R.to_tensor(a, **kw), P.to_tensor(a, **kw)


# ---- dtypes ----

DTYPE_NAMES = ["bool", "uint8", "int8", "int16", "int32", "int64", "float16",
               "bfloat16", "float32", "float64", "complex64", "complex128"]


def test_dtype_names_and_conversions_match_the_reference():
    from paddle_tpu.core import dtype as rd
    from paddle_tpu_torch.core import dtype as pd
    for name in DTYPE_NAMES + ["float", "double", "half", "int", "long"]:
        assert pd.convert_dtype(name).name == rd.convert_dtype(name).name
    for name in DTYPE_NAMES:
        d = pd.convert_dtype(name)
        assert d == name and d == d.torch_dtype and hash(d) == hash(name)
        assert pd.convert_dtype(d.torch_dtype) is d
        ref = rd.convert_dtype(name)
        assert (d.is_floating_point(), d.is_integer(), d.is_complex()) == (
            ref.is_floating_point(), ref.is_integer(), ref.is_complex())
        assert pd.convert_dtype(ref.np_dtype) is d     # ml_dtypes bf16 too
        assert getattr(P, name) == d
    assert P.float32 == np.float32 and P.int64 == np.dtype("int64")
    assert P.float32 != None  # noqa: E711
    with pytest.raises(ValueError):
        pd.convert_dtype("float7")


def test_default_dtype_round_trip():
    assert P.get_default_dtype() == R.get_default_dtype() == "float32"
    try:
        P.set_default_dtype("float64")
        assert P.to_tensor(1.5).dtype == P.float64
        with pytest.raises(TypeError):
            P.set_default_dtype("int32")
    finally:
        P.set_default_dtype("float32")
    assert P.to_tensor(1.5).dtype == P.float32


def test_to_tensor_dtype_rules_match_the_reference():
    for data in (1.5, [1.5, 2.5], [[1.0], [2.0]], (0.25, 3.0), True,
                 [True, False], np.float32([1.5]), np.int32([1, 2]),
                 np.int8([3]), np.bool_([1, 0]), np.float16([0.5])):
        ref, got = pair(data)
        same(got, ref)
        assert got.stop_gradient


def test_to_tensor_keeps_64_bit_data():
    """Python ints and a float64 numpy array keep 64 bits (the reference's
    JAX truncates them); an explicit dtype wins."""
    assert P.to_tensor([1, 2]).dtype == P.int64
    assert P.to_tensor(np.zeros(2)).dtype == P.float64
    assert P.to_tensor(np.zeros(2), dtype="float32").dtype == P.float32
    assert P.to_tensor([1, 2], dtype=P.float16).dtype == P.float16
    t = P.to_tensor(np.ones(3, np.float32), stop_gradient=False)
    u = P.to_tensor(t)
    assert u.stop_gradient and not t.stop_gradient
    np.testing.assert_array_equal(u.numpy(), t.numpy())


def test_bfloat16_numpy_is_exact_float32():
    vals = np.random.RandomState(0).randn(64).astype(np.float32)
    ref, got = pair(vals, dtype="bfloat16")
    assert got.dtype == P.bfloat16
    a = got.numpy()
    assert a.dtype == np.float32
    np.testing.assert_array_equal(a, np.asarray(ref.numpy()).astype(
        np.float32))
    # an ml_dtypes bf16 array (as the reference hands over) reads by its bits
    back = P.to_tensor(ref.numpy())
    assert back.dtype == P.bfloat16
    np.testing.assert_array_equal(back.numpy(), a)


# ---- places ----

def test_places_and_set_device():
    try:
        for name in ("gpu", "cuda", "tpu", "xpu", "gpu:1"):
            p = P.set_device(name)
            assert isinstance(p, P.CUDAPlace)
            idx = int(name.partition(":")[2] or 0)
            assert P.get_device() == f"gpu:{idx}" and p.device_id == idx
        assert isinstance(P.TPUPlace(0), P.CUDAPlace)
        assert P.CUDAPlace(0) == P.CUDAPlace(0) != P.CUDAPlace(1)
        assert P.set_device("cpu") == P.CPUPlace()
        assert P.get_device() == R.get_device() == "cpu"
        assert P.CPUPlace().torch_device() == torch.device("cpu")
        assert isinstance(P.set_device("npu:2"), P.CustomPlace)
    finally:
        P.set_device("cpu")
    assert not P.is_compiled_with_tpu() and not P.is_compiled_with_xpu()
    assert P.device_count() == torch.cuda.device_count()
    x = P.to_tensor([1.0])
    assert x.place == P.CPUPlace() and x.cpu().place == P.CPUPlace()


def test_default_place_is_the_card_and_raises_without_one():
    """No fallback: the default place is CUDAPlace(0); a tensor made there
    without a card raises, in resolve_device's words."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    prev = place_mod._expected_place
    place_mod._expected_place = None
    try:
        assert P.get_device() == "gpu:0"
        for make in (lambda: P.to_tensor([1.0]), lambda: P.Tensor(),
                     lambda: P.Tensor(np.ones(2)), lambda: gen_param()):
            with pytest.raises(RuntimeError, match="set_device\\('cpu'\\)"):
                make()
    finally:
        place_mod._expected_place = prev


def gen_param():
    from paddle_tpu_torch.nn import Layer
    return Layer().create_parameter([2, 2])


# ---- flags ----

def test_flags_match_the_reference():
    from paddle_tpu.core import flags as rf
    from paddle_tpu_torch.core import flags as pf
    assert set(pf._REGISTRY) == set(rf._REGISTRY)
    for k in pf._REGISTRY:
        assert pf._REGISTRY[k]["default"] == rf._REGISTRY[k]["default"]
    assert P.get_flags("check_nan_inf") == R.get_flags("check_nan_inf")
    try:
        P.set_flags({"FLAGS_conv_workspace_size_limit": "64"})
        assert P.get_flags(["conv_workspace_size_limit"]) == {
            "FLAGS_conv_workspace_size_limit": 64}
    finally:
        P.set_flags({"conv_workspace_size_limit": 512})
    with pytest.raises(ValueError):
        P.get_flags("no_such_flag")
    with pytest.raises(ValueError):
        P.set_flags({"no_such_flag": 1})


@pytest.mark.parametrize("level", [0, 1])
def test_check_nan_inf(level, capsys):
    x_r, x_p = pair(np.float32([-1.0, 4.0]))
    try:
        for pkg in (R, P):
            pkg.set_flags({"check_nan_inf": True,
                           "check_nan_inf_level": level})
        if level == 0:
            with pytest.raises(FloatingPointError, match="log"):
                apply("log", torch.log, x_p)
            from paddle_tpu.core.tensor import apply as rapply
            import jax.numpy as jnp
            with pytest.raises(FloatingPointError, match="log"):
                rapply("log", jnp.log, x_r)
        else:
            out = apply("log", torch.log, x_p)
            assert np.isnan(out.numpy()[0])
            assert "Operator log output contains NaN/Inf" in \
                capsys.readouterr().out
        apply("sqrt", torch.sqrt, x_p * x_p)            # finite: no check
    finally:
        for pkg in (R, P):
            pkg.set_flags({"check_nan_inf": False, "check_nan_inf_level": 0})


# ---- the generator ----

def draw(shape=(256,), init=None):
    from paddle_tpu_torch.nn import Layer
    p = Layer().create_parameter(list(shape),
                                 default_initializer=init or I.Normal())
    return p.numpy()


def test_generator_is_deterministic_per_seed():
    P.seed(11)
    a = draw()
    b = draw()
    P.seed(11)
    np.testing.assert_array_equal(draw(), a)
    np.testing.assert_array_equal(draw(), b)
    assert not np.array_equal(a, b)
    P.seed(12)
    assert not np.array_equal(draw(), a)
    assert gen.default_generator().initial_seed() == 12


def test_generator_state_round_trip():
    g = gen.Generator(5)
    fresh = g.get_state()
    first = torch.rand(8, generator=g.torch_generator("cpu"))
    state = g.get_state()
    a = torch.rand(8, generator=g.torch_generator("cpu"))
    g.set_state(state)
    np.testing.assert_array_equal(
        torch.rand(8, generator=g.torch_generator("cpu")).numpy(), a.numpy())
    g.set_state(fresh)                  # a device not yet drawn: from seed
    np.testing.assert_array_equal(
        torch.rand(8, generator=g.torch_generator("cpu")).numpy(),
        first.numpy())
    g.manual_seed(5)
    np.testing.assert_array_equal(
        torch.rand(8, generator=g.torch_generator("cpu")).numpy(),
        first.numpy())


def test_rng_state_tracker():
    """Inside rng_state(name) the default generator draws the named stream,
    which continues across blocks; the default stream is untouched."""
    P.seed(3)
    plain = [draw((16,)), draw((16,))]
    P.seed(3)
    tr = P.get_rng_state_tracker()
    tr.add("mp", 7)
    with pytest.raises(ValueError):
        tr.add("mp", 8)
    with pytest.raises(ValueError):
        with tr.rng_state("nope"):
            pass
    saved = tr.get_states_tracker()
    with tr.rng_state("mp") as g:
        assert g is gen.default_generator()
        m1 = draw((16,))
    d1 = draw((16,))
    with tr.rng_state("mp"):
        m2 = draw((16,))
    d2 = draw((16,))
    np.testing.assert_array_equal(d1, plain[0])
    np.testing.assert_array_equal(d2, plain[1])
    gen.seed(7)
    np.testing.assert_array_equal(m1, draw((16,)))
    np.testing.assert_array_equal(m2, draw((16,)))
    # the tracker's get/set rewinds the named stream; seed() clears it
    P.seed(3)
    tr.set_states_tracker(saved)
    with tr.rng_state("mp"):
        np.testing.assert_array_equal(draw((16,)), m1)
    with tr.rng_state() as g:                       # "global_seed"
        assert g is gen.default_generator()
    P.seed(0)
    assert tr.get_states_tracker() == {}


# ---- dunders ----

RNG = np.random.RandomState(0)
FA = RNG.uniform(0.5, 2.0, (3, 4)).astype(np.float32)
FB = RNG.uniform(0.5, 2.0, (3, 4)).astype(np.float32)
IA = RNG.randint(1, 9, (3, 4)).astype(np.int32)
IB = RNG.randint(1, 9, (3, 4)).astype(np.int32)
BA = RNG.rand(3, 4) > 0.5
BB = RNG.rand(3, 4) > 0.5
BINARY = ["__add__", "__sub__", "__mul__", "__truediv__", "__floordiv__",
          "__mod__", "__pow__", "__eq__", "__ne__", "__lt__", "__le__",
          "__gt__", "__ge__"]
REVERSED = ["__radd__", "__rsub__", "__rmul__", "__rtruediv__",
            "__rfloordiv__", "__rmod__", "__rpow__"]
BITWISE = ["__and__", "__or__", "__xor__"]


@pytest.mark.parametrize("op", BINARY)
def test_binary_dunders_match_the_reference(op):
    """Tensor-tensor (float, int, mixed) and tensor-scalar (Python float
    and int on float and int tensors), then the reversed form."""
    for a, b in ((FA, FB), (IA, IB), (FA, IB), (FA, 1.5), (IA, 2.5),
                 (IA, 3)):
        ra, pa = pair(a)
        rb, pb = pair(b) if isinstance(b, np.ndarray) else (b, b)
        same(getattr(pa, op)(pb), getattr(ra, op)(rb))
    rop = op.replace("__", "__r", 1)
    if rop in REVERSED:
        for arr in (FA, IA):
            for scalar in (1.5, 3):
                ra, pa = pair(arr)
                same(getattr(pa, rop)(scalar), getattr(ra, rop)(scalar))


def test_matmul_unary_and_bitwise_dunders_match_the_reference():
    ra, pa = pair(FA)
    rb, pb = pair(FB.T.copy())
    same(pa @ pb, ra @ rb)
    same(pa.__rmatmul__(pb), ra.__rmatmul__(rb))
    for arr in (FA, IA):
        ra, pa = pair(arr)
        same(-pa, -ra)
        same(abs(-pa), abs(-ra))
    for a, b in ((IA, IB), (BA, BB)):
        ra, pa = pair(a)
        rb, pb = pair(b)
        same(~pa, ~ra)
        for op in BITWISE:
            same(getattr(pa, op)(pb), getattr(ra, op)(rb))


def test_python_protocol_and_properties_match_the_reference():
    ra, pa = pair(FA)
    assert pa.shape == ra.shape == [3, 4] and pa.size == ra.size == 12
    assert pa.ndim == ra.ndim == pa.dim == 2 and pa.numel() == 12
    same(pa.T, ra.T)
    same(pa.mT, ra.mT)
    r3, p3 = pair(FA.reshape(2, 3, 2))
    same(p3.T, r3.T)
    assert len(pa) == len(ra) == 3
    for got, want in zip(pa, ra):
        same(got, want)
    rs, ps = pair(np.float32(2.5))
    assert float(ps) == float(rs) and int(ps) == int(rs) == 2
    assert bool(ps) and format(ps, ".2f") == format(rs, ".2f") == "2.50"
    assert ps.item() == rs.item() and pa.tolist() == ra.tolist()
    ri, pi = pair(np.int32(2))
    assert [1, 2, 3][pi] == [1, 2, 3][ri] == 3
    with pytest.raises(ValueError):
        bool(pa)
    with pytest.raises(TypeError):
        len(ps)
    same(pa.astype("int32"), ra.astype("int32"))
    same(pa.cast(P.float16), ra.cast(R.float16))
    same(pa.clone(), ra.clone())
    assert np.asarray(pa).dtype == np.float32
    assert "shape=[3, 4]" in repr(pa) and hash(pa) == id(pa)
    assert pa.to("float16").dtype == P.float16
    assert pa.to("cpu").place == P.CPUPlace()


def test_dlpack_round_trip():
    _, pa = pair(FA)
    back = torch.from_dlpack(pa)
    np.testing.assert_array_equal(back.numpy(), FA)


def test_parameter_and_detach():
    p = P.Tensor(np.float32([1.0]))
    assert p.stop_gradient and p.is_leaf and p.grad is None
    w = __import__("paddle_tpu_torch.core.tensor",
                   fromlist=["Parameter"]).Parameter(np.float32([1.0, 2.0]))
    assert not w.stop_gradient and w.is_leaf and w.persistable and w.trainable
    y = w * 2
    assert not y.stop_gradient and not y.is_leaf
    d = y.detach()
    assert d.stop_gradient and d.is_leaf and d.name.endswith(".detach")
    y.stop_gradient = True                      # a non-leaf: detached
    assert y.stop_gradient and y.is_leaf
    i = P.to_tensor(np.int32([1]))
    i.stop_gradient = False                     # a flag only on ints
    assert not i.stop_gradient


# ---- indexing ----

X = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
INDICES = {
    "int": 1, "neg_int": -1, "slice": slice(0, 2), "step": slice(None, None, 2),
    "neg_step": slice(None, None, -1), "neg_step_2": (slice(None), slice(2, 0, -1)),
    "tuple": (1, slice(1, 3), 2), "ellipsis": (Ellipsis, 1),
    "none": (None, 0), "list": [1, 0], "array": np.array([0, 1, 1]),
    "bool_mask": X[..., 0] > 5, "adv_pair": ([0, 1], [2, 0]),
    "adv_split": ([0, 1], slice(None), [1, 3]),
    "ellipsis_neg_step": (Ellipsis, slice(None, None, -2)),
}


def test_getitem_matches_the_reference():
    ra, pa = pair(X)
    for name, idx in INDICES.items():
        same(pa[idx], ra[idx])


def test_getitem_with_tensor_indices():
    ra, pa = pair(X)
    ri, pi = pair(np.int32([1, 0]))
    same(pa[pi], ra[ri])
    rm, pm = ra > 10, pa > 10
    same(pa[pm], ra[rm])


@pytest.mark.parametrize("value", ["scalar", "row", "tensor"])
def test_setitem_matches_the_reference(value):
    for name in ("int", "slice", "neg_step", "tuple", "ellipsis", "list",
                 "bool_mask", "adv_pair", "neg_step_2"):
        idx = INDICES[name]
        ra, pa = pair(X)
        target = np.asarray(X[idx]).shape
        if value == "scalar":
            rv = pv = 7.5
        elif value == "row":
            rv = pv = np.arange(target[-1] if target else 1,
                                dtype=np.float32)
        else:
            rv, pv = pair(np.full(target, -3.0, np.float32))
        ra[idx] = rv
        pa[idx] = pv
        same(pa, ra)


# ---- in-place ops ----

@pytest.mark.parametrize("op", ["add_", "subtract_", "multiply_", "divide_",
                                "scale_", "zero_", "fill_", "copy_",
                                "set_value"])
def test_inplace_ops_rebind_as_the_reference(op):
    args = {"add_": (2.0,), "subtract_": (0.5,), "multiply_": (3.0,),
            "divide_": (4.0,), "scale_": (2.0, 1.0), "zero_": (),
            "fill_": (9.0,), "copy_": (FB,), "set_value": (FB,)}[op]
    ra, pa = pair(FA)
    old = pa._t
    reader = pa * 1.0
    rargs = [R.to_tensor(a) if isinstance(a, np.ndarray) else a for a in args]
    pargs = [P.to_tensor(a) if isinstance(a, np.ndarray) else a for a in args]
    assert getattr(pa, op)(*pargs) is pa
    getattr(ra, op)(*rargs)
    same(pa, ra)
    assert pa._t is not old                         # rebound, out of place
    np.testing.assert_array_equal(reader.numpy(), FA)   # readers keep it
