"""Distributed training surface — port of the parts of
`paddle_tpu/distributed` the trainer needs: the auto-parallel `Engine`
and its checkpoints (`checkpoint`).  The communication API, fleet and
the auto-parallel `shard_tensor` surface are not ported (ROADMAP Queue 1
item 13)."""
from .auto_parallel import Engine  # noqa: F401
