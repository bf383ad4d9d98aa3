"""The auto-parallel `Engine` — port of
`paddle_tpu/distributed/auto_parallel` (its `shard_tensor` API and
`ProcessMesh` wait for the port's Tensor: ROADMAP Queue 1 item 13.1)."""
from .engine import Engine  # noqa: F401
