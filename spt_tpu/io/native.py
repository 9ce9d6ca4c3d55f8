"""ctypes bindings for the native runtime library (native/spt_native.cpp).

The compute path is XLA; host-side work that is genuinely serial — Radiance
RGBE scanline decode (the stbi_loadf role, Cubemap.cpp:18-46) — runs in C++
when the shared library is available.  The library is built on demand with
g++ from native/spt_native.cpp and cached next to the source (git ignores
it); every entry point has a pure-Python fallback, so the package works
without a toolchain.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _native_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "native")


def _build(src: str, out: str) -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", src, "-o", out],
            check=True, capture_output=True, timeout=120,
        )
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def load() -> Optional[ctypes.CDLL]:
    """The native library, building it on first use; None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        d = _native_dir()
        src = os.path.join(d, "spt_native.cpp")
        so = os.path.join(d, "libspt_native.so")
        if not os.path.exists(so) or (
            os.path.exists(src) and os.path.getmtime(src) > os.path.getmtime(so)
        ):
            if not (os.path.exists(src) and _build(src, so)):
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None

        lib.spt_rgbe_decode.restype = ctypes.c_int
        lib.spt_rgbe_decode.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ]
        _LIB = lib
        return _LIB


def rgbe_decode(payload: bytes, width: int, height: int) -> Optional[np.ndarray]:
    """Native RGBE decode -> (H, W, 3) float32, or None to use the fallback."""
    lib = load()
    if lib is None:
        return None
    buf = np.frombuffer(payload, np.uint8)
    out = np.empty((height, width, 3), np.float32)
    rc = lib.spt_rgbe_decode(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(buf.size), width, height,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if rc != 0:
        raise ValueError(f"spt_rgbe_decode failed: {rc}")
    return out

