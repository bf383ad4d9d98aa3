"""Device places.

Reference parity: `phi::Place` / `AllocationType` (`paddle/phi/common/place.h:28`) and the
Python ``paddle.CPUPlace()/CUDAPlace(i)`` objects.  Here a Place maps to a torch
device; ``CUDAPlace`` is the accelerator, and ``TPUPlace`` (the reference's
accelerator) and ``XPUPlace`` are kept as names that resolve to the card.

The expected place defaults to ``CUDAPlace(0)`` and never falls back to the
CPU on its own (the reference's does, `paddle_tpu/core/place.py:113`): making
a tensor there without a card raises.  ``set_device("cpu")`` selects the CPU,
where every kernel's plain PyTorch version runs.
"""
from __future__ import annotations

import torch


class Place:
    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place) and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def torch_device(self) -> torch.device:
        raise ValueError(f"{self!r} names no device of this build")


class CPUPlace(Place):
    device_type = "cpu"

    def __repr__(self):
        return "Place(cpu)"

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    """The CUDA card `device_id`."""
    device_type = "gpu"

    def torch_device(self) -> torch.device:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; call "
                               "set_device('cpu') to run the plain PyTorch "
                               "path")
        return torch.device("cuda", self.device_id)


class TPUPlace(CUDAPlace):
    """The reference's accelerator place, kept as a name: the card."""


class XPUPlace(CUDAPlace):
    pass


class CUDAPinnedPlace(CPUPlace):
    pass


class CustomPlace(Place):
    def __init__(self, device_type: str, device_id: int = 0):
        super().__init__(device_id)
        self.device_type = device_type


_expected_place = None


def parse_place(device) -> Place:
    """A Place, or its name ("gpu", "cuda", "tpu" and "xpu" all name the
    card; "cpu"; "gpu:1") -> a Place."""
    if isinstance(device, Place):
        return device
    name, _, idx = str(device).partition(":")
    idx = int(idx) if idx else 0
    if name in ("gpu", "cuda", "tpu", "xpu"):
        return CUDAPlace(idx)
    if name == "cpu":
        return CPUPlace()
    return CustomPlace(name, idx)


def set_device(device) -> Place:
    """paddle.set_device("gpu"/"cuda"/"tpu"/"cpu"/"gpu:1")."""
    global _expected_place
    _expected_place = parse_place(device)
    return _expected_place


def get_device() -> str:
    p = _get_expected_place()
    return f"{p.device_type}:{p.device_id}" if p.device_type != "cpu" else "cpu"


def _get_expected_place() -> Place:
    global _expected_place
    if _expected_place is None:
        _expected_place = CUDAPlace(0)
    return _expected_place


def expected_device() -> torch.device:
    """The torch device of the expected place (raises on `CUDAPlace`
    without a card)."""
    return _get_expected_place().torch_device()


def place_of(device: torch.device) -> Place:
    return CUDAPlace(device.index or 0) if device.type == "cuda" \
        else CPUPlace()


def is_compiled_with_cuda() -> bool:
    return torch.backends.cuda.is_built()


def is_compiled_with_tpu() -> bool:
    return False


def is_compiled_with_xpu() -> bool:
    return False


def is_compiled_with_rocm() -> bool:
    return torch.version.hip is not None


def device_count() -> int:
    """The CUDA cards this process sees (0 without one)."""
    return torch.cuda.device_count()
