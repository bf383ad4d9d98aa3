"""Python wrapper over the C++ shared-memory ring (io/csrc/shm_ring.cc) —
port of `paddle_tpu/io/shm_ring.py`.  The library builds with the port's
`utils.cpp_extension` (g++, C ABI through ctypes) from the port's own copy
of the source, whose byte layout is the JAX package's: a ring made by one
package attaches from the other.

One SPSC ring per DataLoader worker: the worker process pushes serialized
batches, the main process pops them — large batch payloads move through POSIX
shared memory with two memcpys and no pickling through a multiprocessing pipe
(ref mmap_allocator + blocking_queue design).
"""
from __future__ import annotations

import ctypes
import os
import pickle
from typing import Optional

_LIB = None
_LIB_ERR = None


def _lib():
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    try:
        from ..utils.cpp_extension import load
        src = os.path.join(os.path.dirname(__file__), "csrc", "shm_ring.cc")
        lib = load("shm_ring", [src])
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.ring_attach.restype = ctypes.c_void_p
        lib.ring_attach.argtypes = [ctypes.c_char_p]
        lib.ring_push.restype = ctypes.c_int
        lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                  ctypes.c_uint64, ctypes.c_int]
        lib.ring_pop.restype = ctypes.c_long
        lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_uint64, ctypes.c_int,
                                 ctypes.POINTER(ctypes.c_uint64)]
        lib.ring_next_len.restype = ctypes.c_long
        lib.ring_next_len.argtypes = [ctypes.c_void_p]
        lib.ring_close_producer.argtypes = [ctypes.c_void_p]
        lib.ring_size.restype = ctypes.c_uint64
        lib.ring_size.argtypes = [ctypes.c_void_p]
        lib.ring_free.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _LIB = lib
    except Exception as e:  # toolchain or /dev/shm unavailable: the reason
        # stays in _LIB_ERR
        _LIB_ERR = e
        _LIB = None
    return _LIB


def available() -> bool:
    return _lib() is not None


class _Timeout:
    def __repr__(self):
        return "<shm_ring.TIMEOUT>"


TIMEOUT = _Timeout()  # distinct from a legitimately transferred None


class ShmRing:
    """SPSC byte ring over POSIX shared memory."""

    def __init__(self, name: str, capacity: int = 64 << 20, create: bool = True,
                 unlink_on_free: Optional[bool] = None):
        lib = _lib()
        if lib is None:
            raise RuntimeError(f"shm_ring unavailable: {_LIB_ERR}")
        self._lib = lib
        self.name = name if name.startswith("/") else "/" + name
        bname = self.name.encode()
        self._h = lib.ring_create(bname, capacity) if create \
            else lib.ring_attach(bname)
        if not self._h:
            raise RuntimeError(f"shm ring {'create' if create else 'attach'} "
                               f"failed for {self.name}")
        self._unlink = create if unlink_on_free is None else unlink_on_free
        self._buf = ctypes.create_string_buffer(1 << 20)

    # ---- raw bytes ----
    def push_bytes(self, data: bytes, timeout_ms: int = -1) -> bool:
        rc = self._lib.ring_push(self._h, data, len(data), timeout_ms)
        if rc == -2:
            raise ValueError(f"message of {len(data)} bytes exceeds ring "
                             "capacity")
        if rc == -3:
            raise BrokenPipeError("ring closed")
        return rc == 0

    def pop_bytes(self, timeout_ms: int = -1) -> Optional[bytes]:
        need = ctypes.c_uint64(0)
        while True:
            n = self._lib.ring_pop(self._h, self._buf, len(self._buf),
                                   timeout_ms, ctypes.byref(need))
            if n >= 0:
                return self._buf.raw[:n]
            if n == -1:
                return None                      # timeout
            if n == -3:
                raise EOFError("ring closed and drained")
            # -2: grow the scratch buffer and retry
            self._buf = ctypes.create_string_buffer(int(need.value))

    # ---- pickled objects ----
    def put(self, obj, timeout_ms: int = -1) -> bool:
        return self.push_bytes(pickle.dumps(obj, protocol=4), timeout_ms)

    def get(self, timeout_ms: int = -1):
        """Returns the object, or the TIMEOUT sentinel on pop timeout (a
        transferred None comes back as None)."""
        data = self.pop_bytes(timeout_ms)
        return TIMEOUT if data is None else pickle.loads(data)

    def close_producer(self):
        self._lib.ring_close_producer(self._h)

    def size(self) -> int:
        return int(self._lib.ring_size(self._h))

    def free(self):
        if self._h:
            self._lib.ring_free(self._h, 1 if self._unlink else 0)
            self._h = None

    def __del__(self):
        try:
            self.free()
        except Exception:
            pass
