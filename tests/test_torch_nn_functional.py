"""The port's `nn.functional` (`paddle_tpu_torch/nn/functional/`) and
`incubate.nn.functional.fused_dot_product_attention` against the JAX
package's, on the CPU.

Every case of `tests/torch_nn_cases.py` runs through both packages on the
same numpy inputs (`tests/torch_op_test.py::twin`): values at the case's
tolerance (float32 2e-5 abs and rel), integer outputs equal, and the
input gradients of the summed float outputs.  The reference's Pallas
attention has no CPU lane, so on the CPU both packages take their plain
attention.  The functions that draw (dropout, `rrelu`, `gumbel_softmax`,
attention dropout) are held each package against itself: a seed repeats
a draw and another changes it, dropout keeps its share and its mean, and
`gumbel_softmax(hard=True)` is the one-hot of the soft sample's argmax
with the soft sample's gradient (straight-through).
"""
import inspect

import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from torch_nn_cases import ALL, RANDOM, dropout_stats, seeded_repeats
from torch_op_test import on_cpu, twin  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", ALL, ids=lambda c: c.name)
def test_functional_twin(case):
    twin(case)


# functions a case reaches under another name
COVERED_ELSEWHERE = {"zeropad2d": "pad", "scaled_dot_product_attention":
                     "sdpa_*", "binary_cross_entropy_with_logits":
                     "bce_with_logits_pos_weight"}


def test_every_public_function_has_a_case():
    cased = {c.name for c in ALL} | set(RANDOM)
    missing = [n for n in dir(P.nn.functional)
               if not n.startswith("_") and
               inspect.isfunction(getattr(P.nn.functional, n)) and
               n not in COVERED_ELSEWHERE and
               not any(c == n or c.startswith(n + "_") for c in cased)]
    assert missing == []


@pytest.mark.parametrize("ns", [R, P], ids=["reference", "port"])
@pytest.mark.parametrize("name", sorted(RANDOM))
def test_random_functions_repeat_under_one_seed(ns, name):
    a, b, c = seeded_repeats(ns, RANDOM[name])
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("ns", [R, P], ids=["reference", "port"])
def test_dropout_keeps_its_share_and_mean(ns):
    kept, mean, eval_is_input = dropout_stats(ns)
    assert 0.45 < kept < 0.55
    np.testing.assert_allclose(mean, 1.0, atol=0.05)
    assert eval_is_input


@pytest.mark.parametrize("ns", [R, P], ids=["reference", "port"])
def test_gumbel_softmax_hard_is_straight_through(ns):
    x0 = np.random.RandomState(3).randn(4, 6).astype(np.float32)
    w = ns.to_tensor(np.random.RandomState(4).randn(4, 6).astype(np.float32))
    grads = []
    for hard in (True, False):
        x = ns.to_tensor(x0, stop_gradient=False)
        ns.seed(21)
        y = ns.nn.functional.gumbel_softmax(x, temperature=0.7, hard=hard)
        (y * w).sum().backward()
        grads.append((y.numpy(), x.grad.numpy()))
    (hard_y, hard_g), (soft_y, soft_g) = grads
    # onehot + y - y: exact in the reference (XLA folds y - y), within a
    # float32 rounding in torch's eager sum
    np.testing.assert_allclose(hard_y, np.eye(6)[soft_y.argmax(-1)],
                               atol=1e-6)
    np.testing.assert_allclose(hard_g, soft_g, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ns", [R, P], ids=["reference", "port"])
def test_rrelu_training_slopes_lie_in_the_range(ns):
    x = ns.to_tensor(-np.ones((64, 64), np.float32))
    y = ns.nn.functional.rrelu(x, 0.1, 0.3, training=True).numpy()
    assert (-y >= 0.1 - 1e-6).all() and (-y <= 0.3 + 1e-6).all()
    assert y.std() > 0.03


def test_fused_sdpa_dropout_is_drawn_not_dropped():
    """With dropout in training the port draws a mask (the reference's
    plain twin drops dropout without a generator); out of training the
    call is exact."""
    f = P.incubate.nn.functional.fused_dot_product_attention
    q = P.to_tensor(np.random.RandomState(5).randn(1, 16, 2, 8)
                    .astype(np.float32))
    exact = f(q, q, q, dropout_p=0.5, training=False).numpy()
    np.testing.assert_allclose(f(q, q, q).numpy(), exact, rtol=1e-6)
    assert not np.allclose(f(q, q, q, dropout_p=0.5).numpy(), exact)


def test_batch_norm_moves_the_running_stats_outside_the_tape():
    """The running buffers are rebound under no_grad: they stay stop-
    gradient leaves, and a reader recorded before still differentiates
    (no version bump, as the reference writes their data)."""
    rm = P.to_tensor(np.zeros(3, np.float32))
    rv = P.to_tensor(np.ones(3, np.float32))
    x = P.to_tensor(np.random.RandomState(6).randn(4, 3).astype(np.float32),
                    stop_gradient=False)
    first = P.nn.functional.batch_norm(x, rm, rv, training=False)
    P.nn.functional.batch_norm(x, rm, rv, training=True)
    assert rm.stop_gradient and rm.is_leaf and not np.allclose(rm.numpy(), 0)
    first.sum().backward()
    assert x.grad is not None
