"""`paddle.nn` of the port (reference `paddle_tpu/nn/__init__.py`): `Layer`,
the initializers, the functional and Layer modules (activations, common,
containers, conv, losses, norms, pooling, RNN, vision, `MultiHeadAttention`
and the Transformer stacks), gradient clipping, `nn.utils` and decoding
(`BeamSearchDecoder`, `dynamic_decode`)."""
from . import functional  # noqa
from . import initializer  # noqa
from .layer import *  # noqa
from .layer import Layer  # noqa
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue  # noqa
from .utils import clip_grad_norm_, clip_grad_value_, parameters_to_vector, vector_to_parameters  # noqa
from .decode import BeamSearchDecoder, Decoder, dynamic_decode  # noqa
