"""The port's kernels.  `LAUNCH_COUNTED` lists the wrappers that launch a
hand-written kernel, each with a plain integer `launches` counter; the
kernel modules import triton and build CUDA code only inside a launch."""
from .flash_attention import (flash_attention_fwd, flash_attention_seg_fwd,
                              flash_bwd_dkv, flash_bwd_dq, flash_bwd_seg_dkv,
                              flash_bwd_seg_dq)
from .paged_attention import (paged_attention_kernel,
                              paged_prefill_attention_kernel)
from .rms_norm import rms_norm_fused

LAUNCH_COUNTED = (paged_prefill_attention_kernel, flash_attention_fwd,
                  rms_norm_fused, paged_attention_kernel, flash_bwd_dkv,
                  flash_bwd_dq, flash_attention_seg_fwd, flash_bwd_seg_dkv,
                  flash_bwd_seg_dq)


def reset_launches() -> None:
    for fn in LAUNCH_COUNTED:
        fn.launches = 0


def launches() -> dict:
    return {fn.__name__: fn.launches for fn in LAUNCH_COUNTED}
