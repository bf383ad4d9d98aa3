"""paddle.utils.cpp_extension — port of `paddle_tpu/utils/cpp_extension.py`:
JIT-build native host extensions with g++.

Reference parity: `python/paddle/utils/cpp_extension/` (load() JIT-compiles a
user C++ op into a shared library; CppExtension/CUDAExtension/setup for wheel
builds).

Extensions expose a C ABI consumed via ctypes, as the JAX package's do (the
reference's custom-device plugin ABI, `phi/backends/device_ext.h`, makes the
same choice).  Built artifacts are content-hashed and cached under the build
directory — the checkout's git-ignored `build/paddle_tpu_torch/extensions/`
unless `PADDLE_EXTENSION_DIR` names another — so repeat loads are instant.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence

_DEFAULT_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "paddle_tpu_torch" / "extensions"


class ExtensionError(RuntimeError):
    pass


def _build_dir(name):
    root = os.environ.get("PADDLE_EXTENSION_DIR") or str(_DEFAULT_ROOT)
    d = os.path.join(root, name)
    os.makedirs(d, exist_ok=True)
    return d


def load(name: str, sources: Sequence[str], extra_cxx_cflags: Optional[List[str]] = None,
         extra_ldflags: Optional[List[str]] = None, extra_include_paths=None,
         build_directory: Optional[str] = None, verbose: bool = False,
         interpreter=None):
    """JIT-compile C++ sources into a shared library and dlopen it.

    Returns a ctypes.CDLL (C-ABI symbols; the reference returns a python
    module of pybind-registered ops — declare your restypes/argtypes on the
    handle)."""
    srcs = [os.path.abspath(s) for s in sources]
    for s in srcs:
        if not os.path.exists(s):
            raise ExtensionError(f"source not found: {s}")
    cflags = ["-O2", "-fPIC", "-shared", "-std=c++17"] + (extra_cxx_cflags or [])
    for inc in (extra_include_paths or []):
        cflags.append(f"-I{inc}")
    ldflags = (extra_ldflags or []) + ["-lrt", "-lpthread"]
    h = hashlib.sha1()
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    h.update(" ".join(cflags + ldflags).encode())
    out_dir = build_directory or _build_dir(name)
    so_path = os.path.join(out_dir, f"{name}_{h.hexdigest()[:12]}.so")
    if not os.path.exists(so_path):
        # build to a temp path and rename: concurrent builders must never
        # dlopen a half-written .so (rename is atomic within the directory)
        tmp_path = f"{so_path}.tmp.{os.getpid()}"
        cmd = ["g++"] + cflags + srcs + ["-o", tmp_path] + ldflags
        if verbose:
            print("[cpp_extension]", " ".join(cmd))
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise ExtensionError(
                f"building {name} failed:\n{proc.stderr[-4000:]}")
        os.rename(tmp_path, so_path)
    return ctypes.CDLL(so_path)


class CppExtension:
    """setup()-style extension description (ref cpp_extension.CppExtension)."""

    def __init__(self, sources, *args, **kwargs):
        self.sources = sources
        self.kwargs = kwargs


def CUDAExtension(sources, *args, **kwargs):
    raise ExtensionError(
        "CUDAExtension is not built here: the port's device kernels are "
        "CUDA C++ built by paddle_tpu_torch/incubate/kernels/_cuda.py; "
        "host-side native code uses CppExtension")


class BuildExtension:
    @classmethod
    def with_options(cls, **kwargs):
        return cls


def setup(name=None, ext_modules=None, **kwargs):
    """Build every CppExtension immediately into the cache (wheel-less JIT
    variant of the reference setup())."""
    built = []
    for ext in (ext_modules or []):
        if isinstance(ext, CppExtension):
            built.append(load(name or "ext", ext.sources, **{
                k: v for k, v in ext.kwargs.items()
                if k in ("extra_cxx_cflags", "extra_ldflags",
                         "extra_include_paths")}))
    return built


def get_build_directory():
    return _build_dir("")


__all__ = ["load", "CppExtension", "CUDAExtension", "BuildExtension", "setup",
           "get_build_directory", "ExtensionError"]
