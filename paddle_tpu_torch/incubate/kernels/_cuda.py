"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with plain `nvcc` for `sm_90a` into its own
shared library with a C interface, bound with ctypes (pointers and the
stream pass as `c_void_p`).  Libraries land in `build/paddle_tpu_torch/`
beside the package, keyed by a hash of every source under `csrc/`, so an
edited source rebuilds and an unchanged one loads straight away.  All
missing libraries build together, one `nvcc` process per source.
Nothing here runs at import: the first kernel launch builds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

_PKG = Path(__file__).resolve().parents[2]          # paddle_tpu_torch/
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "paddle_tpu_torch"
SOURCES = ("paged_attention", "paged_decode", "flash_attention",
           "flash_attention_bwd", "flash_attention_seg_bwd", "rms_norm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry -> argument types; every entry returns cudaGetLastError() as int
SIGNATURES = {
    "paged_prefill_attention": (
        _P, _P, _P, _P, _P,                     # q k v k_scale v_scale
        _P, _P, _P, _P,                         # table q_offset valid out
        _P, _P,                                 # ws count
        _I, _I, _I, _I, _I, _I, _I,             # B T H KVH hd page max_pages
        _I, _I, _I,                             # ck nsplit gc
        _F, _I, _I, _P),                        # scale dtype kv_dtype stream
    "paged_decode_attention": (
        _P, _P, _P, _P, _P,                     # q k v k_scale v_scale
        _P, _P, _P,                             # table lengths out
        _P, _P,                                 # ws count
        _I, _I, _I, _I, _I, _I,                 # B H KVH hd page max_pages
        _I, _I, _I,                             # ck nsplit warps
        _F, _I, _I, _P),                        # scale dtype kv_dtype stream
    "flash_attention_fwd": (
        _P, _P, _P, _P, _P,                     # q k v out lse
        _I, _I, _I, _I, _I, _I,                 # B S Sk H D causal
        _F, _I, _P),                            # scale dtype stream
    "flash_attention_seg_fwd": (
        _P, _P, _P, _P, _P, _P, _P,             # q k v seg_q seg_k out lse
        _I, _I, _I, _I, _I, _I,                 # B S Sk H D causal
        _F, _I, _P),                            # scale dtype stream
    "flash_attention_bwd_dkv": (
        _P, _P, _P, _P, _P, _P, _P, _P,         # q k v dout lse delta dk dv
        _I, _I, _I, _I, _I, _I,                 # B S Sk H D causal
        _F, _I, _P),                            # scale dtype stream
    "flash_attention_bwd_dq": (
        _P, _P, _P, _P, _P, _P, _P,             # q k v dout lse delta dq
        _I, _I, _I, _I, _I, _I,                 # B S Sk H D causal
        _F, _I, _P),                            # scale dtype stream
    "flash_attention_seg_bwd_dkv": (
        _P, _P, _P, _P, _P, _P, _P, _P,         # q k v dout lse delta seg_q/k
        _P, _P,                                 # dk dv
        _I, _I, _I, _I, _I, _I,                 # B S Sk H D causal
        _F, _I, _P),                            # scale dtype stream
    "flash_attention_seg_bwd_dq": (
        _P, _P, _P, _P, _P, _P, _P, _P,         # q k v dout lse delta seg_q/k
        _P,                                     # dq
        _I, _I, _I, _I, _I, _I,                 # B S Sk H D causal
        _F, _I, _P),                            # scale dtype stream
    "rms_norm": (
        _P, _P, _P,                             # x w out
        _I, _I, _I, _I, _I, _I, _I,             # N D vec nv threads rows
        #                                         stages
        _F, _I, _I, _P),                        # eps x_dtype w_dtype stream
}

_entries: Dict[str, ctypes._CFuncPtr] = {}      # loaded C entries, by name


def _nvcc() -> str:
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def source_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}_{source_hash()}.so"


def build_all() -> Dict[str, Tuple[float, str]]:
    """Compile every source whose library is missing, all `nvcc` processes
    started together.  Returns {source: (seconds, ptxas report)} for what
    was built (empty when everything was already built); raises on a failed
    build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    reports, failed, logs = {}, [], {}
    while procs:                        # reap in finishing order, timed
        for name, (proc, tmp, out) in list(procs.items()):
            if proc.poll() is None:
                continue
            logs[name] = proc.stdout.read()
            proc.stdout.close()
            del procs[name]
            if proc.returncode != 0:
                failed.append(f"--- {name}.cu (nvcc rc {proc.returncode})\n"
                              f"{logs[name]}")
                continue
            os.replace(tmp, out)        # atomic: readers never see halves
            reports[name] = (time.perf_counter() - t0, logs[name])
        time.sleep(0.05)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def entry(name: str, fn: str):
    """The ctypes function `fn` of library `name`, building on first use."""
    f = _entries.get(fn)
    if f is None:
        path = lib_path(name)
        if not path.exists():
            build_all()
        f = getattr(ctypes.CDLL(str(path)), fn)
        f.argtypes = SIGNATURES[fn]
        f.restype = ctypes.c_int
        _entries[fn] = f
    return f


def check(err: int, what: str) -> None:
    """Raise on a C entry's nonzero return: a cudaError_t, or a negative
    code for a launch the entry refused before it."""
    if err < 0:
        raise RuntimeError(f"{what}: the entry refused the launch (code "
                           f"{err})")
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
