"""MoE token dispatch: `dispatch.py`, the port of
`paddle_tpu/incubate/distributed/models/moe/dispatch.py`.  The reference's
Layer API here (`MoELayer`, the gates, `ClipGradForMOEByGlobalNorm`)
arrives with the Paddle API breadth (ROADMAP Queue 1 item 13)."""
from . import dispatch  # noqa: F401
