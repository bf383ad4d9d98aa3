"""The port's ops on the card against the port's ops on the CPU.  Marked
`cuda`: they skip without an NVIDIA GPU.  On a machine with the card and
no jax, run them without the repo's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ops_cuda.py

Every case of the CPU twin tables (`tests/torch_op_cases.py`) runs with
`set_device("gpu:0")` against the same port call with `set_device("cpu")`:
outputs on the card, float values and gradients within the case's
tolerance (2e-5 abs and rel; 1e-4 for decompositions through their
reconstructions), integer, bool and index outputs equal.  Then creation
and random ops land on the card, a seed repeats a draw there, `seed=`
draws stand apart from the global state, `lstsq` refuses the drivers the
card lacks, and an in-place op's stale reader raises there too.
"""
import numpy as np
import pytest
import torch

import paddle_tpu_torch as P
from torch_op_cases import ALL, port_on_device
from torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    prev = P.get_device()
    P.set_device("gpu:0")
    yield "gpu:0"
    P.set_device(prev)


@pytest.mark.parametrize("case", ALL, ids=[c.name for c in ALL])
def test_op_on_the_card_matches_the_cpu(dev, case):
    port_on_device(P, case, dev)


def test_creation_and_random_ops_land_on_the_card(dev):
    x = P.ones([4, 4])
    made = [P.zeros([2]), P.arange(5), P.full([2, 2], 3), P.eye(3),
            P.linspace(0, 1, 4), P.logspace(0, 1, 3), P.tril_indices(3, 3),
            P.triu_indices(3), P.create_parameter([2, 2], "float32"),
            P.create_tensor("float32"), P.rand([3]), P.randn([3]),
            P.uniform([3], seed=4), P.gaussian([3]), P.randint(0, 4, [3]),
            P.randperm(5), P.normal(0.0, 1.0, [2]), P.standard_normal([2]),
            P.multinomial(P.full([6], 1.0), 2), P.bernoulli(x * 0.5),
            P.poisson(x), P.binomial(x * 4, x * 0.5), P.rand_like(x),
            P.randn_like(x), P.randint_like(x, 0, 3), P.exponential_(x),
            P.normal_(P.zeros([2]))]
    for t in made:
        assert t.place == P.CUDAPlace(0), t
    assert P.randint(0, 4, [3]).dtype == P.int64
    assert P.rand([2], dtype="float16").dtype == P.float16


def test_a_seed_repeats_a_draw_on_the_card(dev):
    def draw():
        return np.concatenate([P.rand([64]).numpy(), P.randn([64]).numpy(),
                               P.multinomial(P.full([100], 1.0), 8).numpy()])
    P.seed(21)
    a = draw()
    P.seed(21)
    np.testing.assert_array_equal(draw(), a)
    P.seed(22)
    assert not np.array_equal(draw(), a)
    k = P.uniform([32], seed=5).numpy()
    P.rand([1000])
    np.testing.assert_array_equal(P.uniform([32], seed=5).numpy(), k)
    state = P.get_cuda_rng_state()
    b = P.rand([16]).numpy()
    P.set_cuda_rng_state(state)
    np.testing.assert_array_equal(P.rand([16]).numpy(), b)


def test_lstsq_takes_only_gels_on_the_card(dev):
    rng = np.random.RandomState(0)
    a = P.to_tensor(rng.randn(6, 3).astype(np.float32))
    b = P.to_tensor(rng.randn(6, 2).astype(np.float32))
    want = P.linalg.lstsq(a, b)[0].numpy()
    np.testing.assert_allclose(P.linalg.lstsq(a, b, driver="gels")[0].numpy(),
                               want, rtol=1e-4, atol=1e-4)
    for driver in ("gelsy", "gelsd", "gelss"):
        with pytest.raises(ValueError, match="gels"):
            P.linalg.lstsq(a, b, driver=driver)


def test_an_inplace_stale_read_raises_on_the_card(dev):
    p = P.to_tensor(np.array([2.0], np.float32), stop_gradient=False)
    q = p * 3
    r = q.sin()
    q.exp_()
    with pytest.raises(RuntimeError, match="inplace"):
        r.backward()
    p.clear_grad()
    q = p * 3
    q.log_()
    q.backward()
    np.testing.assert_allclose(p.grad.numpy(), [0.5], rtol=1e-6)
