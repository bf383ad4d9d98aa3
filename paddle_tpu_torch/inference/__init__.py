"""paddle.inference for the port — `paddle_tpu/inference/__init__.py`'s
deployment door: `Config`, `create_predictor`, `PrecisionType`,
`PlaceType`, `get_version`, and the serving classes as lazy attributes.

`create_predictor` routes a causal-LM configuration (a `Config` with
`enable_llm_engine(...)`, or a `models.gpt.GPTConfig` with `params=`) to
the continuous-batching `LLMEngine` on the card, or to an `EngineFleet` of
data-parallel replicas when `replicas > 1` (serve it over HTTP with
`ServingFrontend`).  A `Config` that names a saved program needs the
reference's `Predictor`, which deserialises an exported JAX program: that
arrives with the `jit/` and `static/` slice of the API breadth, and
raises until then.
"""
from __future__ import annotations

from typing import Dict, Optional

from . import cache, engine  # noqa: F401


class PrecisionType:
    Float32 = 0
    Half = 1
    Int8 = 2
    Bfloat16 = 3


class PlaceType:
    UNK = -1
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM = 3


class Config:
    """The reference's `inference.Config`: model paths and engine knobs
    (the placement knobs are recorded and inert)."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        if prog_file is not None and prog_file.endswith(".pdmodel"):
            prog_file = prog_file[:-len(".pdmodel")]
        self._prefix = prog_file
        self._params_file = params_file
        self._flags: Dict[str, object] = {}
        self._llm: Optional[Dict[str, object]] = None

    def enable_llm_engine(self, model_config, params, *, replicas: int = 1,
                          router: str = "affinity", **engine_kwargs):
        """Route this Config to the continuous-batching causal-LM engine:
        `create_predictor` then returns an `LLMEngine`, or with `replicas >
        1` an `EngineFleet` routing across data-parallel replicas.
        `engine_kwargs` go to `LLMEngine` as they are (num_slots,
        page_size, spec_len, kv_tier, device, ...)."""
        self._llm = {"model_config": model_config, "params": params,
                     "replicas": int(replicas), "router": router,
                     "engine_kwargs": engine_kwargs}
        return self

    def set_prog_file(self, path):
        self._prefix = path[:-len(".pdmodel")] if path.endswith(".pdmodel") \
            else path

    def set_params_file(self, path):
        self._params_file = path

    def prog_file(self):
        return (self._prefix or "") + ".pdmodel"

    def params_file(self):
        return self._params_file or (self._prefix or "") + ".pdiparams"

    # placement knobs: accepted and recorded, inert
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._flags["gpu"] = device_id

    def enable_xpu(self, *a, **k):
        self._flags["xpu"] = True

    def disable_gpu(self):
        self._flags.pop("gpu", None)

    def enable_tensorrt_engine(self, *a, **k):
        self._flags["trt"] = True

    def enable_mkldnn(self):
        self._flags["mkldnn"] = True

    def switch_ir_optim(self, flag=True):
        self._flags["ir_optim"] = flag

    def enable_memory_optim(self, flag=True):
        self._flags["memory_optim"] = flag

    def set_cpu_math_library_num_threads(self, n):
        self._flags["threads"] = n

    def summary(self):
        return f"Config(prefix={self._prefix}, flags={self._flags})"


class Predictor:
    """The reference's named-handle predictor over a saved program.  Its
    programs are exported JAX programs; running saved programs arrives with
    the port's `jit/` and `static/`."""

    def __init__(self, config: Config):
        raise engine._later(
            f"Predictor over a saved program ({config.prog_file()}; jit/ "
            f"and static/)", "Paddle API breadth")


def _causal_lm_predictor(model_config, params, *, replicas: int = 1,
                         router: str = "affinity", **engine_kwargs):
    if params is None:
        raise ValueError("causal-LM predictor needs params (the model's "
                         "weight dictionary)")
    if replicas > 1:
        from .router import EngineFleet
        return EngineFleet(params, model_config, replicas=replicas,
                           router=router, engine_kwargs=engine_kwargs)
    return engine.LLMEngine(params, model_config, **engine_kwargs)


def create_predictor(config, params=None, **engine_kwargs):
    """The one door for inference construction, routed by the config's
    kind:

    - a `Config` with `enable_llm_engine(...)` set, or a `models.gpt
      .GPTConfig` passed with `params=` -> `LLMEngine`, or an `EngineFleet`
      when `replicas > 1` (affinity-routed by default);
    - a `Config` naming a saved program -> `Predictor` (raises until the
      `jit/` and `static/` slice)."""
    if isinstance(config, Config):
        if config._llm is not None:
            spec = config._llm
            return _causal_lm_predictor(
                spec["model_config"], spec["params"],
                replicas=spec["replicas"], router=spec["router"],
                **{**spec["engine_kwargs"], **engine_kwargs})
        return Predictor(config)
    # duck-typed causal-LM model config (models.gpt.GPTConfig and friends)
    if hasattr(config, "num_layers") and hasattr(config, "vocab_size"):
        return _causal_lm_predictor(config, params, **engine_kwargs)
    raise TypeError(f"create_predictor: expected an inference.Config or a "
                    f"causal-LM model config, got {type(config).__name__}")


def get_version():
    from .. import __version__
    return __version__


def convert_to_mixed_precision(*a, **k):
    raise NotImplementedError(
        "convert_to_mixed_precision: use amp at train time or serve in "
        "bfloat16 (a pass of the reference's GPU predictor pipeline)")


# the serving classes, imported at first use
_SERVING = {"LLMEngine": "engine", "Request": "engine",
            "RequestOutput": "engine", "RequestMetrics": "engine",
            "PagedKVCache": "cache",
            "DraftProposer": "spec", "NgramProposer": "spec",
            "MetricsRegistry": "metrics", "Counter": "metrics",
            "Gauge": "metrics", "Histogram": "metrics",
            "log_buckets": "metrics", "FleetMetrics": "metrics",
            "RateWindow": "metrics", "RATE_WINDOWS": "metrics",
            "RequestTrace": "tracing",
            "evaluate_engine_health": "health", "HEALTH_STATES": "health",
            "ObservabilityServer": "obs_server",
            "EngineFleet": "router", "FleetHandle": "router",
            "FleetOverloaded": "router", "ReplicaView": "router",
            "rank_replicas": "router", "ROUTER_POLICIES": "router",
            "ServingFrontend": "frontend", "PRIORITY_CLASSES": "frontend"}


def __getattr__(name):
    if name in _SERVING:
        import importlib
        mod = importlib.import_module("." + _SERVING[name], __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Config", "Predictor", "create_predictor", "PrecisionType",
           "PlaceType", "get_version", "convert_to_mixed_precision",
           *_SERVING]
