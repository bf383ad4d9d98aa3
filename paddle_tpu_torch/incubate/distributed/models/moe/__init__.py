"""MoE — port of `paddle_tpu/incubate/distributed/models/moe/`: the token
dispatch (`dispatch.py`), the gates (`NaiveGate`, `GShardGate`,
`SwitchGate`), `MoELayer` and `ClipGradForMOEByGlobalNorm`."""
from . import dispatch  # noqa: F401
from .gate import GShardGate, NaiveGate, SwitchGate  # noqa
from .moe_layer import MoELayer  # noqa
from .grad_clip import ClipGradForMOEByGlobalNorm  # noqa
