"""Device and precision defaults of the port.

f64 is the reference mode: Hopper has a native f64 datapath, so the port
computes in f64 unless a caller asks for f32.  TF32 is switched off for both
matmuls and cuDNN, so an f32 run is full f32.
"""

from __future__ import annotations

import torch

DEFAULT_DTYPE = torch.float64


def initialize() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def default_device() -> torch.device:
    """The first CUDA card when there is one, else the CPU."""
    return torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")


def resolve(device=None, dtype=None) -> tuple[torch.device, torch.dtype]:
    return (torch.device(device) if device is not None else default_device(),
            dtype if dtype is not None else DEFAULT_DTYPE)
