"""Device and precision defaults of the port.

The device is the CUDA card unless a caller passes ``device="cpu"``; with
no card and no such request, ``resolve`` raises.  f64 is the reference
mode: Hopper has a native f64 datapath, so the port computes in f64 unless
a caller asks for f32.  TF32 is switched off for both
matmuls and cuDNN, so an f32 run is full f32.
"""

from __future__ import annotations

import torch

DEFAULT_DTYPE = torch.float64


def initialize() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def default_device() -> torch.device:
    """The first CUDA card.  Without one this raises: the port never moves
    to the CPU unless a caller asks for it with ``device="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "xtddft_tpu_torch: no CUDA device (torch.cuda.is_available() is "
            "False); pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")


def resolve(device=None, dtype=None) -> tuple[torch.device, torch.dtype]:
    """(device, dtype) of an entry point: ``device=None`` is the card."""
    return (torch.device(device) if device is not None else default_device(),
            dtype if dtype is not None else DEFAULT_DTYPE)
