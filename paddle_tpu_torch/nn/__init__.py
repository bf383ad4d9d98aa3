"""`paddle.nn` of the port (reference `paddle_tpu/nn/__init__.py`): `Layer`,
the initializers, the functional and Layer modules of the transformer path
(activations, common, containers, losses, norms, `MultiHeadAttention` and
the Transformer stacks), gradient clipping and `nn.utils`.  Conv, pooling,
vision, RNN, decoding and sparse-op modules wait for ROADMAP item 13.3b."""
from . import functional  # noqa
from . import initializer  # noqa
from .layer import *  # noqa
from .layer import Layer  # noqa
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue  # noqa
from .utils import clip_grad_norm_, clip_grad_value_, parameters_to_vector, vector_to_parameters  # noqa
