"""paddle.framework of the port — port of `paddle_tpu/framework/`: the
core runtime names re-exported, `save`/`load` and the RNG state."""
from ..core.tensor import Parameter, EagerParamBase  # noqa
from ..core.dtype import get_default_dtype, set_default_dtype  # noqa
from ..core.place import (CPUPlace, CUDAPlace, TPUPlace, _get_expected_place)  # noqa
from ..core import place as _place
from .io import save, load  # noqa
from .random import get_rng_state, set_rng_state, seed  # noqa


def in_dygraph_mode():
    return True


def in_dynamic_mode():
    return True


def in_pir_mode():
    return False


def use_pir_api():
    return False


class core:
    """Shim namespace standing in for the pybind `libpaddle` module: the
    runtime the reference binds from C++ is torch's here."""
    from ..core.tensor import Tensor as eager_tensor  # noqa

    @staticmethod
    def is_compiled_with_cuda():
        return _place.is_compiled_with_cuda()

    @staticmethod
    def is_compiled_with_xpu():
        return False

    @staticmethod
    def nvprof_nvtx_push(name):
        if _place.is_compiled_with_cuda():
            import torch
            torch.cuda.nvtx.range_push(name)

    @staticmethod
    def nvprof_nvtx_pop():
        if _place.is_compiled_with_cuda():
            import torch
            torch.cuda.nvtx.range_pop()
