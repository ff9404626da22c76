"""Integral/grid environment shared by the reference build and the response.

One `Env` per (molecule, basis, grid level, device, dtype).  Host integrals
(numpy, native engine) are computed lazily and cached; the tensors the
response consumes live on ``device`` in ``dtype``.  The DF subset of the
JAX package's `scf/env.py`: the metric dressing ``isqrt @ j3c`` runs as a
torch matmul on the device, the DF exchange on the hand-written kernel K1
`df_exchange` in AO mode (the AO basis as both its occupied and its virtual
range, density matrices as its trial vectors).  x2c and the in-core ERI
tensors are not ported yet.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from xtddft_tpu_torch import config
from xtddft_tpu_torch.chem.molecule import Molecule
from xtddft_tpu_torch.grids import build_grid, eval_ao
from xtddft_tpu_torch.kernels.df_exchange import df_exchange
from xtddft_tpu_torch.ints import (
    angular_momentum,
    build_layout,
    dipole,
    ip_overlap,
    kinetic,
    nuclear_attraction,
    overlap,
)


@dataclasses.dataclass
class Env:
    """df=True selects density fitting for J/K (the only J/K the port has):
    a metric-dressed B[P, mu, nu] (naux, nao, nao) is built once from the
    native 3c/2c integrals and the eigendecomposed Coulomb metric."""

    mol: Molecule
    grid_level: int = 3
    df: bool = True
    aux_beta: float = 2.2
    aux_mode: str = "full"
    x2c: bool = False
    device: torch.device | str | None = None
    dtype: torch.dtype | None = None

    def __post_init__(self):
        if not self.df:
            raise NotImplementedError(
                "in-core ERIs: not ported yet; the port's J/K is density "
                "fitted (pass df=True)")
        if self.x2c:
            raise NotImplementedError(
                "x2c Hamiltonian: not ported yet (ROADMAP queue 1, item 12)")
        self.device, self.dtype = config.resolve(self.device, self.dtype)
        self.layout = build_layout(self.mol)
        self.nao = self.layout.nao
        self._df_B_cache: dict[float, torch.Tensor] = {}
        self._df_j3c_cache: dict[float, np.ndarray] = {}
        self._df_meig_cache: dict[float, tuple] = {}
        self._df_isqrt_cache: dict[float, np.ndarray] = {}

    def tensor(self, a) -> torch.Tensor:
        """Host array -> tensor on this Env's device and dtype."""
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    @cached_property
    def S(self):
        return self.tensor(overlap(self.layout))

    @cached_property
    def hcore(self):
        return self.tensor(kinetic(self.layout) + nuclear_attraction(self.layout))

    @cached_property
    def grid(self):
        return build_grid(self.mol, level=self.grid_level)

    @cached_property
    def grid_weights(self):
        return self.tensor(self.grid.weights)

    @cached_property
    def ao(self):
        """(4, ngrid, nao) AO values + gradients on the grid."""
        return self.tensor(eval_ao(self.layout, self.grid.coords, deriv=1))

    @cached_property
    def dip(self):
        return self.tensor(dipole(self.layout))

    @cached_property
    def ipovlp(self):
        return self.tensor(ip_overlap(self.layout))

    @cached_property
    def rxp(self):
        return self.tensor(angular_momentum(self.layout))

    # -- density fitting ----------------------------------------------------
    @cached_property
    def aux_layout(self):
        from xtddft_tpu_torch.ints.autoaux import autoaux_layout

        return autoaux_layout(self.mol, beta=self.aux_beta, mode=self.aux_mode)

    def df_j3c_host(self, omega: float = 0.0) -> np.ndarray:
        """Raw host-f64 (naux, nao, nao) 3-center integrals (not dressed)."""
        omega = float(omega or 0.0)
        if omega not in self._df_j3c_cache:
            from xtddft_tpu_torch.ints.two_electron import eri_3c

            self._df_j3c_cache[omega] = eri_3c(
                self.layout, self.aux_layout, omega=omega or None)
        return self._df_j3c_cache[omega]

    def df_metric_eig_host(self, omega: float = 0.0):
        """(w, U) host-f64 eigendecomposition of the fit metric, truncated
        at w > 1e-10."""
        omega = float(omega or 0.0)
        if omega not in self._df_meig_cache:
            from xtddft_tpu_torch.ints.two_electron import eri_2c

            j2c = eri_2c(self.aux_layout, omega=omega or None)
            w, U = np.linalg.eigh(j2c)
            keep = w > 1e-10
            self._df_meig_cache[omega] = (w[keep], U[:, keep])
        return self._df_meig_cache[omega]

    def df_isqrt_host(self, omega: float = 0.0) -> np.ndarray:
        """Host-f64 (naux, naux) inverse square root of the fit metric."""
        omega = float(omega or 0.0)
        if omega not in self._df_isqrt_cache:
            w, U = self.df_metric_eig_host(omega)
            self._df_isqrt_cache[omega] = (U / np.sqrt(w)[None, :]) @ U.T
        return self._df_isqrt_cache[omega]

    def df_B(self, omega: float = 0.0) -> torch.Tensor:
        """Metric-dressed (naux, nao, nao) fitted tensor on the device, so
        that (mu nu|g|lam sig) ~= sum_P B[P,mn] B[P,ls]; the dressing
        matmul runs on the device.  The host j3c is released once dressed
        (11.4 GB at TTM/dzp); a later ``df_j3c_host`` rebuilds it."""
        omega = float(omega or 0.0)
        if omega not in self._df_B_cache:
            j3c = self.tensor(self.df_j3c_host(omega))
            isqrt = self.tensor(self.df_isqrt_host(omega))
            nx, nao = j3c.shape[0], j3c.shape[1]
            self._df_B_cache[omega] = (isqrt @ j3c.reshape(nx, -1)).reshape(nx, nao, nao)
            del j3c
            self._df_j3c_cache.pop(omega, None)
        return self._df_B_cache[omega]

    def df_B_host(self, omega: float = 0.0) -> np.ndarray:
        """Host numpy copy of :meth:`df_B`."""
        return self.df_B(omega).cpu().numpy()

    # -- DF J/K builds ------------------------------------------------------
    def _coulomb(self, t: torch.Tensor) -> torch.Tensor:
        """J = sum_P B[P] t_P, the Coulomb GEMM (a torch matmul)."""
        B = self.df_B()
        return (t @ B.reshape(B.shape[0], -1)).reshape(B.shape[1:])

    def get_j(self, dm: torch.Tensor) -> torch.Tensor:
        """J[dm] = sum_P B[P] t_P with t_P = sum_ls B[P,l,s] dm[s,l]: two
        matrix-vector products with B (JAX `scf/env.py:238` `_df_j`)."""
        B = self.df_B()
        return self._coulomb(B.reshape(B.shape[0], -1) @ dm.T.reshape(-1))

    def get_k(self, dm: torch.Tensor, omega: float | None = None) -> torch.Tensor:
        """pyscf convention: K_pq = sum_{rs} (pr|sq) dm_rs = sum_P (B[P] dm
        B[P])_pq (JAX `scf/env.py:244` `_df_k`), on K1; ``omega``: the
        long-range erf kernel's own fitted tensor."""
        return self.get_jk(dm[None], omega, with_j=False)[1][0]

    def get_jk(self, dms: torch.Tensor, omega: float | None = None, with_j: bool = True):
        """(J of the summed densities or None, K of each) for a stack dms
        (nz, nao, nao) in one K1 launch: K1's Coulomb intermediate t[x, P]
        is `_df_j`'s t, its exchange is `_df_k`, because B is symmetric in
        its AO pair.  ``with_j`` needs the Coulomb tensor (omega 0).  K1
        sums in its fixed order here: the SCF's 1e-11 Ha energy test sits at
        the rounding of these sums, and a Fock build must repeat bitwise."""
        omega = float(omega or 0.0)
        if with_j and omega:
            raise ValueError("get_jk: J is the Coulomb (omega = 0) tensor's")
        t, K = df_exchange(self.df_B(omega), dms, 0, 0, with_t=with_j)
        return (self._coulomb(t.sum(0)) if with_j else None), K
