"""ctypes bindings for the native threaded depth-frame loader.

The native side (native/dynfu_loader.cpp) is the C++ runtime counterpart of
the reference's dataset path (cv::imread per frame, demo.cpp:85-90): a PNG
decoder behind a worker pool that keeps decoded frames ahead of the
consumer, so host-side image decode overlaps device compute. It needs no
PNG library and no zlib headers: it parses the chunks itself and inflates
with zlib's uncompress() from libz.so.1, resolved at run time.

Builds the shared library on first use from the committed source into the
git-ignored native/build/ (g++, the same command as native/Makefile), and
rebuilds it when the source is newer. Without a C++ compiler the numpy PNG
decoder (io/meshio.py) is used silently; a failed build, a failed load or a
missing libz.so.1 warns with its reason before falling back to it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import warnings
from typing import List, Optional

import numpy as np

_REPO_NATIVE = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "native"))
_LIB_NAME = "libdynfu_loader.so"


def _find_or_build_lib() -> Optional[str]:
    src = os.path.join(_REPO_NATIVE, "dynfu_loader.cpp")
    if not os.path.exists(src):
        return None
    out = os.path.join(_REPO_NATIVE, "build", _LIB_NAME)
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    try:
        subprocess.run(
            ["g++", "-O2", "-std=c++17", "-fPIC", "-shared", src, "-o", out,
             "-lpthread", "-ldl"],
            check=True, capture_output=True, text=True, timeout=120)
    except FileNotFoundError:  # no C++ compiler
        return None
    except subprocess.CalledProcessError as e:
        why = e.stderr.strip()[-400:]
        warnings.warn(f"native depth loader did not build ({why}); decoding "
                      "PNGs with numpy", RuntimeWarning)
        return None
    except subprocess.TimeoutExpired:
        warnings.warn("native depth loader build timed out; decoding PNGs "
                      "with numpy", RuntimeWarning)
        return None
    return out


_lib = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    path = _find_or_build_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        warnings.warn(f"native depth loader built but did not load ({e}); "
                      "decoding PNGs with numpy", RuntimeWarning)
        return None
    lib.dfl_zlib_ready.restype = ctypes.c_int
    lib.dfl_zlib_ready.argtypes = []
    if not lib.dfl_zlib_ready():
        warnings.warn("native depth loader found no libz.so.1 to inflate "
                      "with; decoding PNGs with numpy", RuntimeWarning)
        return None
    lib.dfl_open.restype = ctypes.c_void_p
    lib.dfl_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.dfl_get.restype = ctypes.c_int
    lib.dfl_get.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_size_t,
    ]
    lib.dfl_size.restype = ctypes.c_size_t
    lib.dfl_size.argtypes = [ctypes.c_void_p]
    lib.dfl_close.restype = None
    lib.dfl_close.argtypes = [ctypes.c_void_p]
    lib.dfl_decode_one.restype = ctypes.c_int
    lib.dfl_decode_one.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.c_size_t,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


_MAX_PIXELS = 4096 * 4096


class DepthLoader:
    """Iterates decoded (H, W) int32 mm depth frames with native prefetch.

    Frames must be consumed roughly IN ORDER (the prefetch ring holds
    `queue_depth` decoded frames; seeking far backwards blocks). Falls back
    to synchronous numpy decoding when the native library cannot be built,
    so callers never need to branch.
    """

    def __init__(self, paths: List[str], queue_depth: int = 8, threads: int = 4):
        self.paths = list(paths)
        self._lib = _load()
        self._handle = None
        if self._lib is not None and self.paths:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths]
            )
            self._handle = self._lib.dfl_open(
                arr, len(self.paths), queue_depth, threads
            )
        self._buf = np.empty((_MAX_PIXELS,), np.uint16)

    @property
    def native(self) -> bool:
        return self._handle is not None

    @property
    def decoder(self) -> str:
        return ("native (threaded prefetch)" if self.native
                else "numpy (synchronous)")

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> np.ndarray:
        if not 0 <= i < len(self.paths):
            raise IndexError(i)
        if self._handle is None:
            from dynfu_tpu.io import meshio

            return meshio.load_depth_png(self.paths[i])
        h = ctypes.c_int()
        w = ctypes.c_int()
        rc = self._lib.dfl_get(
            self._handle, i,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            ctypes.byref(h), ctypes.byref(w), self._buf.size,
        )
        if rc != 0:
            raise IOError(f"native decode of {self.paths[i]!r} failed (rc={rc})")
        return (
            self._buf[: h.value * w.value]
            .reshape(h.value, w.value)
            .astype(np.int32)
        )

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def close(self):
        if self._handle is not None:
            self._lib.dfl_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
