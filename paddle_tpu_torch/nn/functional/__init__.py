"""`paddle.nn.functional` of the port: so far the flash-attention API."""
from .flash_attention import flash_attention, flash_attn_unpadded  # noqa: F401
