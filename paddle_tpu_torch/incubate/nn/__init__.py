"""`paddle.incubate.nn` of the port: so far the functional
`fused_dot_product_attention`."""
from . import functional  # noqa: F401
