"""The port's ops against the JAX package's, on the CPU, where torch's
defaults and jnp's differ (`tests/torch_op_cases.py`'s TROUBLE table):

- ties in `topk`, `argsort`, `sort`, `kthvalue`, `mode`, `argmax` and
  `cummax`/`cummin` keep the reference's order (`lax.top_k` and stable
  sorts put the lower index first; the cumulative extremes take the later);
- `median` and `nanmedian` at even counts average the two middle values;
  `quantile`'s five methods as jnp computes them, past the 2**24 elements
  that `torch.quantile` refuses too;
- `lu`'s pivots are LAPACK's 1-based int32 ones, so `lu_unpack` agrees;
- `as_strided` counts `offset` from the data's start;
- `lstsq` is the reference's SVD solve without a driver and
  `torch.linalg.lstsq` with one;
- the decompositions, through their reconstructions, and the index,
  scatter, padding, slicing, creation and logic ops.

Tolerances: float32 2e-5 abs and rel; 1e-4 where a decomposition is
compared through a reconstruction or a long sum.
"""
import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from torch_op_cases import TROUBLE
from torch_op_test import on_cpu, twin  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("case", TROUBLE, ids=[c.name for c in TROUBLE])
def test_trouble_spot_twin(case):
    twin(case)


# ---------------------------------------------------------------------------
# sizes torch's own quantile refuses, drivers
# ---------------------------------------------------------------------------

def test_quantile_past_torchs_2_pow_24_limit():
    """`torch.quantile` refuses inputs above 2**24 elements; the port's
    sorts and interpolates itself, so it answers as numpy does."""
    a = np.random.RandomState(1).rand(2 ** 24 + 3).astype(np.float32)
    got = P.quantile(P.to_tensor(a), [0.1, 0.5, 0.99]).numpy()
    np.testing.assert_allclose(got, np.quantile(a, [0.1, 0.5, 0.99]),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("driver", ["gels", "gelsy", "gelsd", "gelss"])
def test_lstsq_named_driver_on_the_cpu(driver):
    """A named driver goes to torch.linalg.lstsq (on the card only 'gels',
    the cuda twin checks); a full-rank solve agrees with the reference's."""
    rng = np.random.RandomState(2)
    a, b = rng.randn(6, 3).astype(np.float32), rng.randn(6, 2).astype(np.float32)
    want = R.linalg.lstsq(R.to_tensor(a), R.to_tensor(b))[0].numpy()
    got = P.linalg.lstsq(P.to_tensor(a), P.to_tensor(b), driver=driver)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
