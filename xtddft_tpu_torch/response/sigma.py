"""Matrix-free batched sigma operators (the Davidson hot path).

A `SigmaOperator` packages ``matvec(Z) -> AZ`` over stacked trial vectors
(torch tensors on the device) with its diagonal and blocked layout.
Counterpart of the JAX package's `response/sigma.py`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from xtddft_tpu_torch.response.reference_state import Reference
from xtddft_tpu_torch.xc import interface as xci


def _rho0(ref: Reference):
    """Ground-state grid densities (ra, rb, ga, gb) on the Env's device."""
    if ref.spec is not None and ref.spec.needs_tau:
        raise NotImplementedError(
            "meta-GGA reference: the tau channel is not ported yet "
            "(ROADMAP queue 1, item 3)")
    env = ref.env
    r, g = xci.cache_rho(env.ao, env.tensor(np.stack([ref.orbo_a @ ref.orbo_a.T,
                                                      ref.orbo_b @ ref.orbo_b.T])))
    return (r[0], r[1], g[0], g[1])


@dataclasses.dataclass
class SigmaOperator:
    matvec: Callable  # (n, dim) tensor -> (n, dim) tensor
    hdiag: np.ndarray
    dim: int
    _to_blocked: Callable | None = None
    device: torch.device | None = None  # where matvec computes
    dtype: torch.dtype | None = None

    def init_guess(self, nstates: int, spread: float = 1e-3) -> np.ndarray:
        """Koopmans guess: unit vectors on the lowest diagonal gaps; every
        gap within ``spread`` of the n-th one is included, so degenerate
        gaps can give more rows than ``nstates``."""
        n = min(nstates, self.dim)
        thresh = np.partition(self.hdiag, n - 1)[n - 1] + spread
        idx = np.where(self.hdiag <= thresh)[0]
        x0 = np.zeros((idx.size, self.dim))
        x0[np.arange(idx.size), idx] = 1.0
        return x0

    def to_blocked(self, v: np.ndarray) -> np.ndarray:
        return v if self._to_blocked is None else self._to_blocked(v)
