"""Runtime flag registry.

Reference parity: gflags + ``PHI_DEFINE_EXPORTED_*`` (`paddle/phi/core/flags.cc`, 93 flags)
surfaced to Python via ``paddle.set_flags/get_flags``
(`paddle/fluid/pybind/global_value_getter_setter.cc`).  Flags read their default from the
environment (``FLAGS_<name>``), like the reference.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Union

_REGISTRY: Dict[str, dict] = {}


def _coerce(value, proto):
    if isinstance(proto, bool):
        if isinstance(value, str):
            return value.lower() in ("1", "true", "yes", "on")
        return bool(value)
    if isinstance(proto, int) and not isinstance(proto, bool):
        return int(value)
    if isinstance(proto, float):
        return float(value)
    return value


def define_flag(name: str, default: Any, doc: str = "") -> None:
    env = os.environ.get(name if name.startswith("FLAGS_") else f"FLAGS_{name}")
    value = _coerce(env, default) if env is not None else default
    _REGISTRY[_norm(name)] = {"value": value, "default": default, "doc": doc}


def _norm(name: str) -> str:
    return name if name.startswith("FLAGS_") else f"FLAGS_{name}"


def get_flags(flags: Union[str, Iterable[str]]) -> Dict[str, Any]:
    if isinstance(flags, str):
        flags = [flags]
    out = {}
    for f in flags:
        key = _norm(f)
        if key not in _REGISTRY:
            raise ValueError(f"unknown flag {f!r}")
        out[key] = _REGISTRY[key]["value"]
    return out


def set_flags(flags: Dict[str, Any]) -> None:
    for k, v in flags.items():
        key = _norm(k)
        if key not in _REGISTRY:
            raise ValueError(f"unknown flag {k!r}")
        _REGISTRY[key]["value"] = _coerce(v, _REGISTRY[key]["default"])


def flag(name: str) -> Any:
    return _REGISTRY[_norm(name)]["value"]


# Core flag set (the reference's subset, the same names and defaults).
define_flag("check_nan_inf", False, "check every op output for NaN/Inf (nan_inf_utils parity)")
define_flag("check_nan_inf_level", 0, "0: error on nan/inf; >=1: log only")
define_flag("benchmark", False, "sync after every op for timing")
define_flag("eager_delete_tensor_gb", 0.0, "GC threshold (no-op: torch's allocator owns memory)")
define_flag("fraction_of_gpu_memory_to_use", 0.92, "accepted for compat; torch's caching allocator governs")
define_flag("allocator_strategy", "auto_growth", "compat; device memory is torch-managed")
define_flag("cudnn_deterministic", False, "compat")
define_flag("embedding_deterministic", 0, "compat")
define_flag("matmul_precision", "default", "compat")
define_flag("use_stride_kernel", True, "compat only")
define_flag("tensor_construct_check", False, "validate values on Tensor construction")
define_flag("low_precision_op_list", 0, "record ops run in low precision (amp audit)")
define_flag("log_memory_stats", False, "log live buffer stats each step")
define_flag("init_allocated_mem", False, "compat only")
define_flag("conv_workspace_size_limit", 512, "compat only")
define_flag("enable_pir_api", False, "compat")
define_flag("prim_all", False, "compat")
define_flag("use_fused_attention", True, "route nn attention through the flash kernels when possible")
define_flag("flash_attn_version", 2, "compat")
define_flag("tpu_matmul_bf16", False, "force bf16 matmuls outside amp")
