"""paddle.framework.random — port of `paddle_tpu/framework/random.py`."""
from ..core import generator as _gen
from ..ops.random import get_rng_state, set_rng_state  # noqa

seed = _gen.seed
