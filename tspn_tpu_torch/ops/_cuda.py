"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

The sources under ``tspn_tpu_torch/csrc/`` expose plain C entry points,
so they compile with ``nvcc`` alone in seconds, without PyTorch's
headers. The library is built at first use into
``build/tspn_tpu_torch/`` at the repository root, named by a hash of its
source, the directory's shared headers (``*.cuh``) and the flags, and
rebuilt whenever that hash changes. Nothing here
runs at import time: the CPU test suite imports every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tspn_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict = {}
build_seconds: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library(name: str) -> ctypes.CDLL:
    """Build (unless this source's build exists) and load
    ``csrc/<name>.cu``; loaded once per process. ``build_seconds[name]``
    records the nvcc time of a build made by this process."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}_{digest}.so"
    if not so.exists():
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) for {src}:\n{proc.stderr}"
            )
        os.replace(tmp, so)
        build_seconds[name] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    _loaded[name] = lib
    return lib


def _bound(name: str, entry: str, n_ptrs: int, n_ints: int, n_floats: int = 0) -> ctypes.CDLL:
    """``library(name)`` with ``entry(n_ptrs pointers, n_ints ints,
    n_floats floats, stream) -> cudaError_t`` typed for ctypes."""
    lib = library(name)
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
            + [ctypes.c_float] * n_floats + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
    return lib


def q8s_sm90_library() -> ctypes.CDLL:
    return _bound("q8s_sm90", "tspn_q8s_sm90_launch", 8, 10)


def q8i8_library() -> ctypes.CDLL:
    return _bound("q8s", "tspn_q8i8_launch", 6, 5)


def pair_probe_library() -> ctypes.CDLL:
    return _bound("pair_probe", "tspn_pair_probe_launch", 3, 8)


def q8_bf16_library() -> ctypes.CDLL:
    return _bound("q8_bf16", "tspn_q8_bf16_launch", 5, 5)


def fused_classify_library() -> ctypes.CDLL:
    return _bound("fused_classify", "tspn_fused_classify_launch", 6, 4)


def fused_classify_prep_library() -> ctypes.CDLL:
    return _bound("fused_classify", "tspn_fused_classify_prep_launch", 2, 2)


def fused_classify_bf16_library() -> ctypes.CDLL:
    return _bound("fused_classify_bf16", "tspn_fused_classify_bf16_launch", 4, 5)


def q8f_fused_library() -> ctypes.CDLL:
    return _bound("q8f_fused", "tspn_q8f_fused_launch", 8, 5)


def roi_align_library() -> ctypes.CDLL:
    return _bound("roi_align", "tspn_roi_align_launch", 4, 8)


def roi_align_bf16_library() -> ctypes.CDLL:
    return _bound("roi_align", "tspn_roi_align_bf16_launch", 4, 8)


def roi_align_backward_library() -> ctypes.CDLL:
    return _bound("roi_align", "tspn_roi_align_backward_launch", 4, 9)


def roi_align_levels_library() -> ctypes.CDLL:
    return _bound("roi_align", "tspn_roi_align_levels_launch", 8, 15, n_floats=4)


def roi_align_levels_backward_library() -> ctypes.CDLL:
    return _bound("roi_align", "tspn_roi_align_levels_backward_launch", 8, 15, n_floats=4)


def roi_sep_fused_library() -> ctypes.CDLL:
    return _bound("roi_probes", "tspn_roi_sep_fused_launch", 3, 8)


def roi_gemm_library() -> ctypes.CDLL:
    return _bound("roi_probes", "tspn_roi_gemm_launch", 3, 9)


def rel_library() -> ctypes.CDLL:
    return _bound("rel", "tspn_rel_launch", 9, 9)


def nms_library() -> ctypes.CDLL:
    return _bound("nms", "tspn_nms_launch", 7, 3, n_floats=1)


def grouped_wgrad_library() -> ctypes.CDLL:
    return _bound("grouped_wgrad", "tspn_grouped_wgrad_launch", 4, 8)


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
