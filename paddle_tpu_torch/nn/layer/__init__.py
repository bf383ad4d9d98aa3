"""`paddle.nn.layer` of the port (reference `paddle_tpu/nn/layer/__init__.py`):
`Layer` and the activation, common, container, conv, loss, norm, pooling,
RNN, transformer and vision layers."""
from .layers import Layer  # noqa
from .activation import *  # noqa
from .common import *  # noqa
from .container import LayerDict, LayerList, ParameterList, Sequential  # noqa
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,  # noqa
                   Conv3DTranspose)
from .loss import *  # noqa
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,  # noqa
                   InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
                   LocalResponseNorm, SpectralNorm, SyncBatchNorm)
from .pooling import *  # noqa
from .rnn import (GRU, GRUCell, LSTM, LSTMCell, RNN, BiRNN, RNNCellBase, SimpleRNN,  # noqa
                  SimpleRNNCell)
from .transformer import (MultiHeadAttention, Transformer, TransformerDecoder,  # noqa
                          TransformerDecoderLayer, TransformerEncoder,
                          TransformerEncoderLayer)
from .vision import ChannelShuffle, PixelShuffle, PixelUnshuffle  # noqa
