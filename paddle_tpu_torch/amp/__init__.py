"""`paddle.amp` of the port — `paddle_tpu/amp/` over torch dtypes."""
from .auto_cast import amp_guard, auto_cast, decorate  # noqa
from .grad_scaler import AmpScaler, GradScaler  # noqa
from . import debugging  # noqa


def is_bfloat16_supported(device=None):
    """The H100's tensor cores take bf16."""
    return True


def is_float16_supported(device=None):
    """True where the expected place is the CUDA card."""
    from ..core.place import _get_expected_place
    return _get_expected_place().device_type == "gpu"
