"""The port's kernels.  `LAUNCH_COUNTED` lists the wrappers that launch a
hand-written kernel, each with a plain integer `launches` counter; `ROUTED`
lists the model-facing entries that send shapes the kernels do not take to
their plain versions on the card, each counting those calls in
`composed_calls`.  Both count Python calls: a CUDA graph's replay calls no
wrapper, so its owner (`inference.graphs`) adds the counts its capture
made (`counts`, `add_counts`) at every replay.  The two paged kernels count
their int8 lane apart, in `launches_int8` (`INT8_COUNTED`,
`launches_int8()`).  The kernel modules build their CUDA code (nvcc,
`_cuda.py`) only inside a launch."""
from .flash_attention import (flash_attention_fused, flash_attention_fwd,
                              flash_attention_seg_fwd, flash_attention_varlen,
                              flash_bwd_dkv, flash_bwd_dq, flash_bwd_seg_dkv,
                              flash_bwd_seg_dq)
from .paged_attention import (paged_attention_decode, paged_attention_kernel,
                              paged_prefill_attention,
                              paged_prefill_attention_kernel)
from .rms_norm import rms_norm_fused

LAUNCH_COUNTED = (paged_prefill_attention_kernel, flash_attention_fwd,
                  rms_norm_fused, paged_attention_kernel, flash_bwd_dkv,
                  flash_bwd_dq, flash_attention_seg_fwd, flash_bwd_seg_dkv,
                  flash_bwd_seg_dq)
INT8_COUNTED = (paged_prefill_attention_kernel, paged_attention_kernel)
ROUTED = (flash_attention_fused, flash_attention_varlen,
          paged_prefill_attention, paged_attention_decode)


def reset_launches() -> None:
    """Zero every launch count and every composed-route count."""
    for fn in LAUNCH_COUNTED:
        fn.launches = 0
    for fn in INT8_COUNTED:
        fn.launches_int8 = 0
    for fn in ROUTED:
        fn.composed_calls = 0


def launches() -> dict:
    return {fn.__name__: fn.launches for fn in LAUNCH_COUNTED}


def launches_int8() -> dict:
    """Launches of the paged kernels' int8 lane (over int8 pools)."""
    return {fn.__name__: fn.launches_int8 for fn in INT8_COUNTED}


def composed_calls() -> dict:
    return {fn.__name__: fn.composed_calls for fn in ROUTED}


def counts() -> dict:
    """Every launch and composed-route count, keyed by (entry, attribute)."""
    return {**{(fn, "launches"): fn.launches for fn in LAUNCH_COUNTED},
            **{(fn, "launches_int8"): fn.launches_int8
               for fn in INT8_COUNTED},
            **{(fn, "composed_calls"): fn.composed_calls for fn in ROUTED}}


def add_counts(delta: dict) -> None:
    """Add a `counts`-keyed delta (negative parts take counts back)."""
    for (fn, attr), n in delta.items():
        setattr(fn, attr, getattr(fn, attr) + n)
