"""The inputs of a cell, made from its configuration and ``--seed``.

A frozen copy of the port's synthetic DF generator
(`xtddft_tpu_torch/response/sigma_df.py` ``synthetic_df_data``), kept here
so that a later change to the program's generator cannot move the
yardstick, at the widths of a real molecule.  Everything large is made on
the device from one ``torch.Generator`` in a few large calls, in the
configuration's dtype:

- ``B[P] = G_P G_P^T * scale`` with rank-``k`` factors ``G`` (symmetric
  and positive semi-definite by construction), 256 aux rows at a time so
  that B is the only full-size buffer; ``scale`` sets the orbitals' mean
  self-Coulomb integral (ii|ii) = sum_P B[P]_ii^2, which is
  naux k (k + 2) scale^2 for standard normal G, to the configuration's
  ``b_coulomb`` (Hartree);
- the MO grid table ``phi`` (value and three gradient rows) and the
  quadrature weights, each orbital normalised on the quadrature (sum_g w_g
  phi0_i(g)^2 = 1, its gradient rows by the same factor); the ground-state
  density made from the table and the occupations, rho_s = sum_i phi0_i^2
  over the spin's occupied orbitals and grad rho_s = 2 sum_i phi0_i grad
  phi_i, so that it integrates to the electron count.

The MO Fock matrices are the molecule's own, read from a checkpoint whose
sha256 the configuration pins; the HF-flavoured pair of the
spin-adaptation terms is that pair plus small symmetric noise from the
configuration's own fixed seed (the program's generator's recipe), so that
the diagonal, and with it the Davidson's path, does not change with
``--seed``.

The same ``Inputs`` go to the port and to the plain reference.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import pathlib

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[2]
DTYPES = {"float32": torch.float32, "float64": torch.float64}
# torch.Generator takes any seed below 2**64; the driver's are non-negative
SEED_MOD = 1 << 63


@dataclasses.dataclass
class Inputs:
    nc: int
    no: int
    nv: int
    xc: str
    B: torch.Tensor                 # (naux, nmo, nmo)
    phi: torch.Tensor               # (4, ngrid, nmo): value, d/dx, d/dy, d/dz
    grid_w: torch.Tensor            # (ngrid,)
    rho0: tuple                     # (ra, rb, ga (3, ngrid), gb)
    fock_mo: np.ndarray             # (2, nmo, nmo) alpha, beta; host f64
    fock_hf_mo: np.ndarray | None   # (2, nmo, nmo) for the spin-adaptation terms

    @property
    def nmo(self) -> int:
        return self.nc + self.no + self.nv

    @property
    def naux(self) -> int:
        return int(self.B.shape[0])

    @property
    def ngrid(self) -> int:
        return int(self.grid_w.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        return self.B.dtype


def _sym(a: np.ndarray) -> np.ndarray:
    return 0.5 * (a + a.T)


def hf_pair(fock_mo: np.ndarray, seed: int, noise: float) -> np.ndarray:
    """The HF-flavoured Fock pair of the spin-adaptation terms: each spin's
    Fock matrix plus symmetric noise of size ``noise``, from a host
    generator of the configuration's seed."""
    rng = np.random.default_rng(seed)
    return np.stack([_sym(f + noise * rng.standard_normal(f.shape)) for f in fock_mo])


def checkpoint_fock(path: str, sha256: str, nc: int, no: int, nv: int) -> np.ndarray:
    """The MO Fock matrices C^T F_s C of a ROKS checkpoint, its orbitals in
    core | open | virtual order, after checking the file's hash and its
    occupations against the configuration."""
    f = REPO / path
    digest = hashlib.sha256(f.read_bytes()).hexdigest()
    if digest != sha256:
        raise RuntimeError(f"{path}: sha256 {digest}, the configuration pins {sha256}")
    with np.load(f) as d:
        occ = d["mo_occ"]
        order = np.concatenate([np.where(occ >= 2)[0], np.where(occ == 1)[0],
                                np.where(occ == 0)[0]])
        counts = ((occ >= 2).sum(), (occ == 1).sum(), (occ == 0).sum())
        if tuple(int(c) for c in counts) != (nc, no, nv):
            raise RuntimeError(f"{path}: (nc, no, nv) = {counts}, configuration {(nc, no, nv)}")
        C = d["mo_coeff"][:, order]
        return np.stack([C.T @ d["fock_a"] @ C, C.T @ d["fock_b"] @ C])


def make_inputs(cfg: dict, seed: int, device, fock_mo: np.ndarray | None = None) -> Inputs:
    """The cell's inputs from the configuration ``cfg`` and ``seed``;
    ``fock_mo`` stands in for the checkpoint's matrices where given (the
    CPU tests' cut-down cells)."""
    dtype = DTYPES[cfg["dtype"]]
    nc, no, nv = cfg["nc"], cfg["no"], cfg["nv"]
    nmo, naux, ngrid, k = nc + no + nv, cfg["naux"], cfg["ngrid"], cfg["b_rank"]
    g = torch.Generator(device).manual_seed(int(seed) % SEED_MOD)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=device, dtype=dtype)

    B = torch.empty((naux, nmo, nmo), dtype=dtype, device=device)
    scale = math.sqrt(cfg["b_coulomb"] / (naux * k * (k + 2)))
    for p0 in range(0, naux, 256):
        G = normal(min(256, naux - p0), nmo, k)
        torch.bmm(G, G.transpose(1, 2), out=B[p0:p0 + G.shape[0]])
        B[p0:p0 + G.shape[0]] *= scale
        del G
    phi = normal(4, ngrid, nmo) / math.sqrt(nmo)
    w = 0.01 + 0.99 * torch.rand((ngrid,), generator=g, device=device, dtype=dtype)
    phi /= torch.sqrt(torch.einsum("g,gi->i", w, phi[0] * phi[0]))

    def density(nocc):
        p0 = phi[0, :, :nocc]
        return (torch.sum(p0 * p0, dim=1),
                2.0 * torch.einsum("gi,ygi->yg", p0, phi[1:, :, :nocc]))
    ra, ga = density(nc + no)
    rb, gb = density(nc)
    fock = cfg["fock"]
    if fock_mo is None:
        fock_mo = checkpoint_fock(fock["path"], fock["sha256"], nc, no, nv)
    fock_hf_mo = hf_pair(fock_mo, fock["hf_seed"], fock["hf_noise"])
    return Inputs(nc=nc, no=no, nv=nv, xc=cfg["xc"], B=B, phi=phi, grid_w=w,
                  rho0=(ra, rb, ga, gb), fock_mo=fock_mo, fock_hf_mo=fock_hf_mo)
