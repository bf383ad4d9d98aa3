"""`paddle.nn.layer` of the port (reference `paddle_tpu/nn/layer/__init__.py`):
`Layer` and the activation, common, container, loss, norm and transformer
layers.  Conv, pooling, RNN and vision layers wait for ROADMAP item 13.3b."""
from .layers import Layer  # noqa
from .activation import *  # noqa
from .common import *  # noqa
from .container import LayerDict, LayerList, ParameterList, Sequential  # noqa
from .loss import *  # noqa
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,  # noqa
                   InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
                   LocalResponseNorm, SpectralNorm, SyncBatchNorm)
from .transformer import (MultiHeadAttention, Transformer, TransformerDecoder,  # noqa
                          TransformerDecoderLayer, TransformerEncoder,
                          TransformerEncoderLayer)
