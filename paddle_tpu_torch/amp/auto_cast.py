"""AMP autocast — port of `paddle_tpu/amp/auto_cast.py` (reference:
`python/paddle/amp/auto_cast.py:687`, `decorate` :755).

Fills the AMP slot of `core.tensor.apply`, the interposition point of the
reference's AMP_LOGIC stage: under `auto_cast`, every op's floating inputs
(float64 aside) are cast by the op's name — O1: white-list ops to the low
dtype, black-list ops to float32, the rest ("gray") left as they arrive;
O2: everything but the black list to the low dtype.  The casts are `apply`
ops themselves, so gradients flow back to float32 parameters in float32;
they are not cast again (the reference's O2 recurses without end on a
float32 input, `paddle_tpu/amp/auto_cast.py:42`, where the port runs it).

`decorate(level="O2")` rebinds each parameter outside the norm layers to
its low-precision value (`nn.layer.layers._retype`: the same wrapper, a
leaf as before, no version bump, as the reference assigns `_data`), so the
optimizer and `.grad` keep seeing the same objects; the optimizers' float32
accumulators are the master state.
"""
from __future__ import annotations

import contextlib

import torch

from ..core import dtype as _dt
from ..core import tensor as _tensor_mod
from ..core.tensor import Tensor
from . import amp_lists


class _AmpState:
    def __init__(self, enabled, dtype, level, custom_white_list,
                 custom_black_list):
        self.enabled = enabled
        self.dtype = _dt.to_torch(dtype)
        self.level = level
        self.white = amp_lists.white_list() | set(custom_white_list or ())
        self.black = (amp_lists.black_list() | set(custom_black_list or ())) \
            - set(custom_white_list or ())

    def cast_inputs(self, op_name, inputs):
        if op_name == "cast":
            # the casts below are `apply` ops too: under O2 the reference
            # casts them again and recurses without end
            return inputs
        if self.level == "O2":
            # O2: everything except the black list runs in low precision
            target = torch.float32 if op_name in self.black else self.dtype
        elif op_name in self.white:
            target = self.dtype
        elif op_name in self.black:
            target = torch.float32
        else:
            return inputs  # gray: leave as-is
        out = []
        for x in inputs:
            if isinstance(x, Tensor) and x._t.is_floating_point() and \
                    x._t.dtype not in (torch.float64, target):
                out.append(x.astype(target))
            else:
                out.append(x)
        return out


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """paddle.amp.auto_cast: bf16 by default (fp16 accepted and honoured)."""
    prev = _tensor_mod._amp_state
    state = _AmpState(enable, dtype, level, custom_white_list,
                      custom_black_list) if enable else None
    _tensor_mod._set_amp_state(state)
    try:
        yield
    finally:
        _tensor_mod._set_amp_state(prev)


amp_guard = auto_cast


def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """O2 decoration: cast the models' floating parameters, outside the
    norm layers (or `excluded_layers`), to `dtype`; the optimizers keep
    float32 accumulators (they already do: the master state)."""
    from ..nn.layer.layers import Layer, _retype
    from ..nn.layer.norm import LayerNorm, _BatchNormBase

    single_model = isinstance(models, Layer)
    model_list = [models] if single_model else list(models)
    if level == "O2":
        td = _dt.to_torch(dtype)
        excluded = tuple(excluded_layers) if excluded_layers \
            else (_BatchNormBase, LayerNorm)
        for m in model_list:
            for lyr in m.sublayers(include_self=True):
                if isinstance(lyr, excluded):
                    continue
                for p in lyr._parameters.values():
                    if p is not None and p._t.is_floating_point():
                        _retype(p, dtype=td)
    if optimizers is None:
        return models if single_model else model_list
    return (models if single_model else model_list), optimizers
