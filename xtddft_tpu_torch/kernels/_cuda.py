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
