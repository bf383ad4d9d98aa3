"""The port's ops against the JAX package's, on the CPU: the ops-only
cases of `tests/test_ops_breadth.py`, the in-place variants and the random
ops (the spots where torch's defaults and jnp's differ are in
`tests/test_torch_ops_trouble.py`).

- BREADTH: `new_math_ops_against_numpy`, `frexp_vander_addn`, `renorm`,
  `unflatten_unfold_vsplit_reverse`, `tensordot_and_lu_unpack`,
  `pca_lowrank` and `lu_unpack_batched` as twin cases (their loss, segment,
  distribution and sparse cases wait for `nn/`, `incubate/`,
  `distribution/` and `sparse/`); the four in-place tests as twins here.
- Every in-place variant of `ops/inplace.py` against the reference's.
- Random ops: the port's streams are torch's, not threefry's, so they are
  held to the reference's shapes and dtypes, to the device set, to their
  moments (bounds below), to a seed's repeat and to the state round trip.

Tolerances: float32 2e-5 abs and rel; 1e-4 where a decomposition is
compared through a reconstruction (and for `tensordot`, the reference's
1e-3); the moments' bounds at `test_random_moments`.
"""
import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from paddle_tpu_torch.ops import inplace as port_inplace
from torch_op_cases import BREADTH, assert_close
from torch_op_test import on_cpu, twin  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", BREADTH, ids=[c.name for c in BREADTH])
def test_breadth_twin(case):
    twin(case)


# ---------------------------------------------------------------------------
# in-place variants and the version counter (test_ops_breadth.py's four)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ns", [R, P], ids=["reference", "port"])
def test_inplace_value_and_identity(ns):
    t = ns.to_tensor(np.array([1.0, 4.0], np.float32))
    r = t.sqrt_()
    assert r is t
    np.testing.assert_allclose(t.numpy(), [1.0, 2.0])
    ns.exp_(t)
    np.testing.assert_allclose(t.numpy(), np.exp([1.0, 2.0]), rtol=1e-6)


@pytest.mark.parametrize("ns", [R, P], ids=["reference", "port"])
def test_inplace_grad_flows(ns):
    p = ns.to_tensor(np.array([2.0], np.float32))
    p.stop_gradient = False
    q = p * 3
    q.exp_()
    q.backward()
    np.testing.assert_allclose(p.grad.numpy(), 3 * np.exp(6.0), rtol=1e-5)


@pytest.mark.parametrize("ns", [R, P], ids=["reference", "port"])
def test_inplace_stale_read_raises(ns):
    p = ns.to_tensor(np.array([2.0], np.float32))
    p.stop_gradient = False
    q = p * 3
    r = q.sin()
    q.exp_()  # r's recorded input modified in place
    with pytest.raises(RuntimeError, match="inplace"):
        r.backward()


@pytest.mark.parametrize("ns", [R, P], ids=["reference", "port"])
def test_inplace_logic_and_clip(ns):
    t = ns.to_tensor(np.array([0.5, 3.0], np.float32))
    t.clip_(0.0, 1.0)
    np.testing.assert_allclose(t.numpy(), [0.5, 1.0])
    a = ns.to_tensor(np.array([1.0, 5.0], np.float32))
    a.greater_than_(ns.to_tensor(np.array([2.0, 2.0], np.float32)))
    np.testing.assert_array_equal(a.numpy(), [False, True])


def test_inplace_on_a_view_leaves_its_base_readers_alone():
    """A view is a wrapper of its own, with its own version: an in-place op
    on it leaves the base's readers alone, and the op's own node
    differentiates too."""
    a = P.to_tensor(np.array([[1.0, 2.0], [3.0, 4.0]], np.float32),
                    stop_gradient=False)
    r = P.sin(a)
    row = P.reshape(a, [4])          # a view of a's value
    row.exp_()
    (P.sum(r) + P.sum(row)).backward()
    want = np.cos(a.numpy()) + np.exp(a.numpy())
    np.testing.assert_allclose(a.grad.numpy(), want, rtol=1e-6)


_X = np.array([[0.3, 0.6, 0.2], [0.8, 0.45, 0.7]], np.float32)
_Y = np.array([[0.5, 0.25, 0.9], [0.4, 0.65, 0.3]], np.float32)
_INT = np.array([[3, 6, 5], [12, 9, 7]], np.int32)
_IDX = np.array([[2, 0], [1, 1]], np.int64)
_BINARY = {"multiply", "pow", "remainder", "subtract", "divide",
           "floor_divide", "mod", "greater_equal", "greater_than",
           "less_equal", "less_than", "not_equal", "equal", "add"}


def _inplace_args(ns, name):
    """(target array, the variant's other arguments) of `<name>_`."""
    op = name[:-1]
    if op in _BINARY:
        return _X, (ns.to_tensor(_Y),)
    if op in ("logical_and", "logical_or", "logical_xor"):
        return _X > 0.5, (ns.to_tensor(_Y > 0.5),)
    if op == "logical_not":
        return _X > 0.5, ()
    if op == "addmm":
        return _X[:, :2].copy(), (ns.to_tensor(_X[:, 1:]), ns.to_tensor(_Y[:, :2]))
    if op in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        return _INT, (ns.to_tensor(_INT[::-1].copy()),)
    if op == "bitwise_not":
        return _INT, ()
    return _X, {
        "clip": (0.35, 0.65), "lerp": (ns.to_tensor(_Y), 0.3),
        "polygamma": (1,),
        "index_put": ((ns.to_tensor(np.array([1, 0])),),
                      ns.to_tensor(np.float32([9.0, 8.0, 7.0]))),
        "put_along_axis": (ns.to_tensor(_IDX), 5.0, 1),
        "cast": ("float16",), "tril": (0,), "triu": (1,),
        "renorm": (2.0, 0, 0.5), "scale": (2.0, 1.0)}.get(op, ())


@pytest.mark.parametrize("name", port_inplace.__all__)
def test_inplace_variant_twin(name):
    """`paddle.<op>_(x, ...)` and `x.<op>_(...)` return x itself, holding
    the reference's value and dtype."""
    out = {}
    for ns in (R, P):
        target, args = _inplace_args(ns, name)
        x = ns.to_tensor(target)
        assert getattr(ns, name)(x, *args) is x
        y = ns.to_tensor(target)
        assert getattr(y, name)(*args) is y
        assert_close(y.numpy(), x.numpy(), 0, name)
        out[ns] = x
    assert out[P].dtype.name == out[R].dtype.name, name
    assert_close(out[P].numpy(), out[R].numpy(), 2e-5, name)


def test_inplace_variants_are_the_references():
    from paddle_tpu.ops import inplace as ref_inplace
    assert sorted(port_inplace.__all__) == sorted(ref_inplace.__all__)


# ---------------------------------------------------------------------------
# random ops
# ---------------------------------------------------------------------------

def _draws(ns):
    """{op: a draw} of every random op of the reference's namespace."""
    ns.seed(11)
    x = ns.to_tensor(np.full((4, 5), 0.5, np.float32))
    probs = ns.to_tensor(np.float32([[0.1, 0.2, 0.7], [0.5, 0.5, 0.0]]))
    out = {
        "uniform": ns.uniform([3, 4], min=-2.0, max=2.0),
        "uniform_f16": ns.uniform([3, 4], dtype="float16"),
        "rand": ns.rand([2, 3]), "randn": ns.randn([2, 3]),
        "standard_normal": ns.standard_normal([5]),
        "normal": ns.normal(1.0, 2.0, [3]),
        "normal_tensors": ns.normal(ns.zeros([2, 3]), ns.ones([3])),
        "gaussian": ns.gaussian([2, 2], mean=3.0, std=0.5),
        "randint": ns.randint(0, 10, [4]),
        "randint_like": ns.randint_like(x, 0, 5),
        "randperm": ns.randperm(6),
        "multinomial": ns.multinomial(probs, 2),
        "multinomial_replacement": ns.multinomial(probs, 4, replacement=True),
        "bernoulli": ns.bernoulli(x), "rand_like": ns.rand_like(x), "randn_like": ns.randn_like(x),
    }
    for name in ("bernoulli_", "exponential_", "cauchy_", "log_normal_",
                 "normal_", "uniform_"):
        t = ns.to_tensor(np.zeros((2, 3), np.float32))
        assert getattr(ns, name)(t) is t
        out[name] = t
    t = ns.to_tensor(np.zeros((2, 3), np.float32))
    out["geometric_"] = ns.geometric_(t, 0.3)
    return out


# the random ops whose draws are int64 in the port and int32 in the
# reference (its JAX has 64-bit types off; Paddle's are int64)
RANDOM_INT64 = {"randint", "randperm", "multinomial",
                "multinomial_replacement"}


def test_random_ops_have_the_references_shapes_and_dtypes():
    want, got = _draws(R), _draws(P)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
        pair = (want[k].dtype.name, got[k].dtype.name)
        if k in RANDOM_INT64:
            assert pair == ("int32", "int64"), k
        else:
            assert pair[0] == pair[1], (k, pair)
        assert got[k].place == P.CPUPlace(), k
    # poisson's and binomial's samplers take jax seconds to compile: their
    # dtypes are held to the reference's rule here (binomial's int64 as
    # the other integer draws)
    x = P.to_tensor(np.full((4, 5), 0.5, np.float32))
    assert P.poisson(x).dtype.name == "float32"
    b = P.binomial(P.full([3], 10.0), P.full([3], 0.5))
    assert b.dtype.name == "int64" and b.shape == [3]


N = 200_000
MOMENT_SIGMAS = 6    # a mean within 6 standard errors of the draw's mean


def _close_mean(sample, mean, var, what):
    se = np.sqrt(var / sample.size)
    assert abs(sample.mean() - mean) <= MOMENT_SIGMAS * se + 1e-6, \
        (what, sample.mean(), mean)


def test_random_moments():
    """Each op's sample mean lies within 6 standard errors of its
    distribution's mean (N = 200000), and the variance of the uniform and
    normal draws within 2% of theirs."""
    P.seed(3)
    u = P.uniform([N], min=-2.0, max=4.0).numpy()
    assert u.min() >= -2.0 and u.max() < 4.0
    _close_mean(u, 1.0, 3.0, "uniform")
    assert abs(u.var() / 3.0 - 1) < 0.02
    z = P.randn([N]).numpy()
    _close_mean(z, 0.0, 1.0, "randn")
    assert abs(z.var() - 1) < 0.02
    g = P.gaussian([N], mean=3.0, std=0.5).numpy()
    _close_mean(g, 3.0, 0.25, "gaussian")
    nm = P.normal(-1.0, 2.0, [N]).numpy()
    _close_mean(nm, -1.0, 4.0, "normal")
    ri = P.randint(2, 9, [N]).numpy()
    assert ri.min() == 2 and ri.max() == 8
    _close_mean(ri, 5.0, (7 ** 2 - 1) / 12, "randint")
    p = P.full([N], 0.3)
    _close_mean(P.bernoulli(p).numpy(), 0.3, 0.21, "bernoulli")
    _close_mean(P.poisson(P.full([N], 4.0)).numpy(), 4.0, 4.0, "poisson")
    _close_mean(P.binomial(P.full([N], 10.0), P.full([N], 0.2)).numpy(), 2.0,
                1.6, "binomial")
    e = P.exponential_(P.zeros([N]), lam=2.0).numpy()
    _close_mean(e, 0.5, 0.25, "exponential_")
    geo = P.geometric_(P.zeros([N]), 0.25).numpy()
    _close_mean(geo, 4.0, 0.75 / 0.0625, "geometric_")
    ln = P.log_normal_(P.zeros([N]), mean=0.0, std=0.5).numpy()
    _close_mean(np.log(ln), 0.0, 0.25, "log_normal_")
    c = P.cauchy_(P.zeros([N]), loc=1.0, scale=2.0).numpy()
    assert abs(np.median(c) - 1.0) < 0.05
    probs = np.float32([0.1, 0.2, 0.3, 0.4])
    m = P.multinomial(P.to_tensor(np.tile(probs, (N // 10, 1))), 1,
                      replacement=True).numpy().reshape(-1)
    freq = np.bincount(m, minlength=4) / m.size
    assert np.all(np.abs(freq - probs) < 6 * np.sqrt(probs * (1 - probs) / m.size))
    w = P.multinomial(P.to_tensor(probs), 4).numpy()
    assert sorted(w.tolist()) == [0, 1, 2, 3]       # without replacement
    perm = P.randperm(1000).numpy()
    assert sorted(perm.tolist()) == list(range(1000))


def test_a_seed_repeats_a_draw_and_seed_args_stand_apart():
    def draw():
        return np.concatenate([P.rand([8]).numpy(), P.randn([8]).numpy(),
                               P.randint(0, 100, [8]).numpy(),
                               P.multinomial(P.full([50], 1.0), 3).numpy()])
    P.seed(5)
    a = draw()
    P.seed(5)
    np.testing.assert_array_equal(draw(), a)
    P.seed(6)
    assert not np.array_equal(draw(), a)
    k = P.uniform([16], seed=7).numpy()
    P.rand([100])                                  # move the global state
    np.testing.assert_array_equal(P.uniform([16], seed=7).numpy(), k)
    np.testing.assert_array_equal(P.gaussian([4], seed=7).numpy(),
                                  P.gaussian([4], seed=7).numpy())
    t = P.zeros([16])
    np.testing.assert_array_equal(P.uniform_(t, seed=7).numpy(), k)


@pytest.mark.parametrize("pair", [("get_rng_state", "set_rng_state"),
                                  ("get_cuda_rng_state", "set_cuda_rng_state")])
def test_rng_state_round_trip(pair):
    get, put = (getattr(P, n) for n in pair)
    P.seed(9)
    P.rand([3])
    state = get()
    a = P.rand([5]).numpy()
    P.rand([7])
    put(state)
    np.testing.assert_array_equal(P.rand([5]).numpy(), a)
