"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``) through ctypes.

Each kernel source (with the headers of ``csrc/``, such as the GEMM tile
core ``gemm_tile.cuh``) compiles into its own shared library with a plain C
interface (``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared``), built
at first use into the gitignored ``build/`` directory and rebuilt when the
source changes.  Nothing here runs at import time: the CPU tests import the
kernel modules on hosts that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from xtddft_tpu_torch.buildlib import build_library

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_LIBS: dict[str, ctypes.CDLL] = {}

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong

# the fixed-order mode's workspace: at most this many slices (splits of a
# reduction) within this many bytes, and never fewer than one slice
FIXED_MAX_SLICES = 64
FIXED_BUDGET_BYTES = 1 << 29


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: cannot build the kernels")
    return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")


def load(name: str, argtypes: list) -> ctypes.CDLL:
    """Build (once per source hash) and load ``csrc/<name>.cu``; bind its
    ``<name>_f32`` and ``<name>_f64`` entry points with ``argtypes``."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_library(name, [CSRC / f"{name}.cu"], [_nvcc(), *NVCC_FLAGS],
                             headers=tuple(sorted(CSRC.glob("*.cuh"))))
        lib = ctypes.CDLL(str(path))
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = I
        lib.xk_error_string.argtypes = [I]
        lib.xk_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def entry(name: str, argtypes: list, dtype: torch.dtype):
    lib = load(name, argtypes)
    if dtype == torch.float64:
        return lib, getattr(lib, f"{name}_f64")
    if dtype == torch.float32:
        return lib, getattr(lib, f"{name}_f32")
    raise TypeError(f"{name}: float32 or float64 tensors only, got {dtype}")


def extra_entry(name: str, argtypes: list, func: str, func_args: list, dtype: torch.dtype):
    """A second C entry ``<func>_f32`` / ``<func>_f64`` of ``csrc/<name>.cu``
    (the library loaded with ``argtypes`` for its own entries), bound with
    ``func_args``."""
    lib = load(name, argtypes)
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: float32 or float64 tensors only, got {dtype}")
    fn = getattr(lib, f"{func}_{'f64' if dtype == torch.float64 else 'f32'}")
    if fn.argtypes is None:
        fn.argtypes = func_args
        fn.restype = I
    return lib, fn


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise on a refused launch (the C entry returns cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {lib.xk_error_string(rc).decode()}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: tensors on {dev}, expected cpu or cuda")
    dt = tensors[0].dtype
    for t in tensors:
        if t.device != dev or t.dtype != dt:
            raise ValueError(f"{name}: all tensors must share device and dtype "
                             f"({t.device}/{t.dtype} vs {dev}/{dt})")


def workspace(per_slice: int, like: torch.Tensor) -> torch.Tensor:
    """The fixed-order mode's workspace: slices of ``per_slice`` elements,
    one per split of a launch's reduction, as many as ``FIXED_BUDGET_BYTES``
    holds (at least one, at most ``FIXED_MAX_SLICES``); the kernel cuts its
    split to the slices it gets.  A failed allocation raises: the mode never
    falls back to atomics."""
    n = max(1, min(FIXED_MAX_SLICES, FIXED_BUDGET_BYTES // (per_slice * like.element_size())))
    return torch.empty(n * per_slice, dtype=like.dtype, device=like.device)
