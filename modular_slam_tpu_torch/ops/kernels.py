"""Build, load and count the hand-written CUDA kernels in `csrc/`.

Each kernel source is compiled by `nvcc` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds) and
loaded with `ctypes`.  The build runs at first use, from the sources in
this checkout, into `csrc/build/` (listed in `.gitignore`); a library is
named by a hash of its source and flags, so an edited source is rebuilt.
`build_all()` starts one `nvcc` per source, all at once.

Every C entry point takes device pointers and the CUDA stream as
`c_void_p`, sizes as `c_int`, launches on that stream without
synchronising, and returns `cudaGetLastError()`; `CudaKernel.launch`
raises if that is not 0.

Each kernel counts its launches in `CudaKernel.launches`, a plain int
that the wrapper bumps once per launch and nowhere else.  Nothing here
runs at import time: this module is imported on machines with no CUDA
toolkit, where only the plain versions of the kernels run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional, Sequence, Tuple

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC")


class KernelBuildError(RuntimeError):
    pass


class KernelLaunchError(RuntimeError):
    pass


def _nvcc() -> str:
    path = shutil.which("nvcc")
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if path is None and os.path.exists(default):
        path = default
    if path is None:
        raise KernelBuildError(
            "nvcc not found: the CUDA kernels are built from csrc/ at first "
            "use on a machine with the CUDA toolkit")
    return path


class CudaKernel:
    """One `.cu` source, its C entry point and its launch count."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: str):
        self.name = name
        self.source = os.path.join(_CSRC, source)
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self._fn = None
        self._lock = threading.Lock()

    @property
    def source_relpath(self) -> str:
        root = os.path.dirname(os.path.dirname(_CSRC))
        return os.path.relpath(self.source, root)

    def library_path(self) -> str:
        with open(self.source, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR,
                            f"lib{stem}-{digest.hexdigest()[:12]}.so")

    def start_build(self) -> Optional[Tuple[subprocess.Popen, str]]:
        """Start nvcc for this source, into a temporary file, unless its
        library exists."""
        if os.path.exists(self.library_path()):
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{self.library_path()}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True), tmp

    def finish_build(self, job: Optional[Tuple[subprocess.Popen, str]]):
        """Wait for a started build and move its library into place."""
        if job is None:
            return
        proc, tmp = job
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc failed for {self.source} "
                                   f"(rc {proc.returncode}):\n{log}")
        os.replace(tmp, self.library_path())

    def load(self):
        """The C entry point, building the library first if needed."""
        with self._lock:
            if self._fn is None:
                self.finish_build(self.start_build())
                lib = ctypes.CDLL(self.library_path())
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
            return self._fn

    def launch(self, *args) -> None:
        err = self.load()(*args)
        if err != 0:
            raise KernelLaunchError(
                f"{self.name}: CUDA error {err} at launch")
        self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)

FAST_SCORE = CudaKernel(
    "fast_score", "fast_score.cu", "mslam_fast_score_levels",
    # srcs[n], dsts[n], H[n], W[n], first_tile[n + 1], n, B, stream
    [_PP, _PP, _PI, _PI, _PI, _I, _I, _P],
    replaces="modular_slam_tpu/ops/fast_pallas.py:49")

HAMMING_2NN = CudaKernel(
    "hamming_2nn", "hamming_2nn.cu", "mslam_hamming_2nn_splits",
    # q, t, t_valid, best, idx, second, B, Nq, L, S, chunks per split,
    # q batch stride, t batch stride, t_valid batch stride, stream
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _LL, _LL, _LL, _P],
    replaces="modular_slam_tpu/ops/match_pallas.py:61")

HAMMING_MERGE = CudaKernel(
    "hamming_merge", "hamming_merge.cu", "mslam_hamming_merge",
    # best, idx, second, q_valid, lm_slot, distance, valid, B, S, Nq,
    # q_valid batch stride, max_hamming, lowe_ratio, stream
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _F, _F, _P],
    replaces="modular_slam_tpu/ops/match_pallas.py:182-196")

KERNELS: Dict[str, CudaKernel] = {
    k.name: k for k in (FAST_SCORE, HAMMING_2NN, HAMMING_MERGE)}


def build_all() -> None:
    """Build and load every kernel library, one nvcc per source, all
    started together."""
    jobs = [(k, k.start_build()) for k in KERNELS.values()]
    for k, job in jobs:
        k.finish_build(job)
    for k in KERNELS.values():
        k.load()


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS.values()}
