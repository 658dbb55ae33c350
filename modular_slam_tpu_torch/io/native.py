"""ctypes bindings to the native C++ data loader, `native/png_loader.cpp`
(counterpart of modular_slam_tpu/io/native.py; the C++ source lies outside
both packages and is shared).

The shared library is built at first use with `make -C native` into
`native/libmslam_native.so` (written under a temporary name and renamed,
so a process never loads a half-written library), when `make`, a C++
compiler and the libpng headers are present; `available()` says whether
it loaded.  Public surface:

- decode_png(path) -> np.ndarray | None  (uint8 [H,W,3], uint8 [H,W] or
  uint16 [H,W]);
- PrefetchLoader: decode-ahead threads over paired (rgb, depth) path
  lists, optionally converting rgb to 8-bit luma in the threads.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
_SO_NAME = "libmslam_native.so"
_SO_PATH = os.path.join(_NATIVE_DIR, _SO_NAME)

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    tmp = f"{_SO_NAME}.{os.getpid()}"
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR, f"TARGET={tmp}"],
                       check=True, capture_output=True, timeout=120)
        os.replace(os.path.join(_NATIVE_DIR, tmp), _SO_PATH)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(os.path.join(_NATIVE_DIR, tmp)):
            os.remove(os.path.join(_NATIVE_DIR, tmp))


def _open() -> Optional[ctypes.CDLL]:
    try:
        return ctypes.CDLL(_SO_PATH)
    except OSError:
        return None


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded at the first call; None when it
    cannot be built or loaded (tried once per process).  A library that
    does not load (another process may be writing it) is built again."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib = _open() if os.path.exists(_SO_PATH) else None
    if lib is None and _build():
        lib = _open()
    if lib is None:
        return None
    lib.msl_png_info.restype = ctypes.c_int
    lib.msl_png_info.argtypes = [ctypes.c_char_p] + [
        ctypes.POINTER(ctypes.c_int)] * 4
    lib.msl_png_read.restype = ctypes.c_int
    lib.msl_png_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.msl_prefetch_create2.restype = ctypes.c_void_p
    lib.msl_prefetch_create2.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.msl_prefetch_get.restype = ctypes.c_int
    lib.msl_prefetch_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.msl_prefetch_destroy.restype = None
    lib.msl_prefetch_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def decode_png(path: str) -> Optional[np.ndarray]:
    """uint8 [H,W,3] for 8-bit color PNGs, uint8 [H,W] for 8-bit gray,
    uint16 [H,W] for 16-bit gray; None on any failure (the caller moves
    on to the next decoder)."""
    lib = _load()
    if lib is None:
        return None
    w, h, ch, depth = (ctypes.c_int() for _ in range(4))
    if lib.msl_png_info(path.encode(), ctypes.byref(w), ctypes.byref(h),
                        ctypes.byref(ch), ctypes.byref(depth)) != 0:
        return None
    if depth.value == 16 and ch.value == 1:
        out = np.empty((h.value, w.value), np.uint16)
    elif depth.value == 8 and ch.value == 3:
        out = np.empty((h.value, w.value, 3), np.uint8)
    elif depth.value == 8 and ch.value == 1:
        out = np.empty((h.value, w.value), np.uint8)
    else:
        return None
    if lib.msl_png_read(path.encode(),
                        out.ctypes.data_as(ctypes.c_void_p)) != 0:
        return None
    return out


class PrefetchLoader:
    """Decode-ahead loader over paired (rgb, depth) PNG lists of one
    resolution: rgb 8-bit color, depth 16-bit gray.  `to_gray=True`
    converts rgb to 8-bit luma in the decode threads; `get` then returns
    gray uint8 [H,W]."""

    def __init__(self, rgb_paths: List[str], depth_paths: List[str],
                 n_threads: int = 4, ring: int = 8,
                 to_gray: bool = False):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        if len(rgb_paths) != len(depth_paths):
            raise ValueError(f"{len(rgb_paths)} rgb paths, "
                             f"{len(depth_paths)} depth paths")
        self._lib = lib
        self._handle = None
        self._n = len(rgb_paths)
        self._to_gray = to_gray
        probe = decode_png(rgb_paths[0])       # the sequence's resolution
        if probe is None or probe.ndim != 3:
            raise RuntimeError(f"bad rgb frame: {rgb_paths[0]}")
        self._h, self._w = probe.shape[:2]
        # the C side reads these path arrays while the threads run
        self._rgb_bufs = (ctypes.c_char_p * self._n)(
            *[p.encode() for p in rgb_paths])
        self._depth_bufs = (ctypes.c_char_p * self._n)(
            *[p.encode() for p in depth_paths])
        self._handle = lib.msl_prefetch_create2(
            self._rgb_bufs, self._depth_bufs, self._n, n_threads, ring,
            int(to_gray))
        if not self._handle:
            raise RuntimeError("prefetcher creation failed")

    def __len__(self) -> int:
        return self._n

    def get(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """-> (rgb uint8 [H,W,3], or gray uint8 [H,W] with to_gray; depth
        uint16 [H,W]); blocks until frame `idx` is decoded."""
        shape = (self._h, self._w) if self._to_gray else (self._h, self._w,
                                                          3)
        rgb = np.empty(shape, np.uint8)
        dep = np.empty((self._h, self._w), np.uint16)
        w, h = ctypes.c_int(), ctypes.c_int()
        rc = self._lib.msl_prefetch_get(
            self._handle, idx, rgb.ctypes.data_as(ctypes.c_void_p),
            dep.ctypes.data_as(ctypes.c_void_p), ctypes.byref(w),
            ctypes.byref(h))
        if rc != 0:
            raise IOError(f"frame {idx} failed to decode")
        return rgb, dep

    def close(self) -> None:
        if self._handle:
            self._lib.msl_prefetch_destroy(self._handle)
            self._handle = None

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
