"""Analytic nuclear gradients for Hartree-Fock references (RHF/UHF/ROHF).

Counterpart of the JAX package's `grad/analytic.py`:

    dE/dA = Tr(D dh/dA) + 1/2 Gamma . d(pq|rs)/dA - Tr(W dS/dA) + dEnuc/dA

with W = sum_s D_s F_s D_s (the energy-weighted density, valid at any
converged SCF stationary point including the Roothaan ROHF one) and
Gamma_pqrs = Dtot_pq Dtot_rs - sum_s Ds_ps Ds_qr.  The one-electron
derivative integrals come from the host engine (`ints/one_electron.py`);
the two-electron term, JAX's host loop over shell quartets
(`_grad_eri_contract`), is one call of K5 `eri_grad` on the Env's device
(its plain version on the CPU).  DFT needs the grid terms: use
`grad.lagrangian.scf_gradient`.
"""

from __future__ import annotations

import numpy as np
import torch

from xtddft_tpu_torch.ints.one_electron import ip_kinetic, ip_overlap, ip_rinv
from xtddft_tpu_torch.kernels.eri_grad import eri_grad

__all__ = ["grad_nuc", "hf_gradient"]


def grad_nuc(mol) -> np.ndarray:
    """(natm, 3) derivative of the nuclear repulsion."""
    z = mol.charges
    r = mol.coords
    g = np.zeros((mol.natm, 3))
    for i in range(mol.natm):
        for j in range(mol.natm):
            if i == j:
                continue
            rij = r[i] - r[j]
            g[i] -= z[i] * z[j] * rij / np.linalg.norm(rij) ** 3
    return g


def hf_gradient(mf) -> np.ndarray:
    """(natm, 3) analytic HF gradient of a converged RHF/UHF/ROHF MeanField;
    its two-electron term on the mean field's device."""
    if mf.xc is not None:
        raise NotImplementedError(
            "hf_gradient is HF-only (no DFT grid-response terms); use "
            "grad.lagrangian.scf_gradient or grad.fd_gradient")
    env = mf.env
    layout = env.layout
    mol = env.mol
    natm = mol.natm
    dm = np.asarray(mf.make_rdm1())
    if dm.ndim == 3:
        da, db = dm[0], dm[1]
    else:
        da = db = 0.5 * dm
    dtot = da + db

    # energy-weighted density W = sum_s D_s F_s D_s
    W = da @ np.asarray(mf.fock_a) @ da + db @ np.asarray(mf.fock_b) @ db
    atom_mask = np.zeros((natm, layout.nao))
    atom_mask[layout.ao_atoms, np.arange(layout.nao)] = 1.0

    g = grad_nuc(mol)
    # overlap (Pulay) term: dS/dA[pq] = -dS_ip[x,p,q] (p on A) - (q on A)
    g += 2.0 * np.einsum("Ap,xpq,pq->Ax", atom_mask, ip_overlap(layout), W)
    g -= 2.0 * np.einsum("Ap,xpq,pq->Ax", atom_mask, ip_kinetic(layout), dtot)
    # nuclear attraction: basis-centre part and operator-centre part
    for C, (Z, Rc) in enumerate(zip(mol.charges, mol.coords)):
        ipr = ip_rinv(layout, Rc)
        g += 2.0 * Z * np.einsum("Ap,xpq,pq->Ax", atom_mask, ipr, dtot)
        g[C] -= 2.0 * Z * np.einsum("xpq,pq->x", ipr, dtot)

    # two-electron term: 1/2 Gamma . d(pq|rs)/dA
    da_t, db_t, dt_t = (env.tensor(x) for x in (da, db, dtot))
    Gamma = torch.einsum("pq,rs->pqrs", dt_t, dt_t)
    Gamma -= torch.einsum("ps,qr->pqrs", da_t, da_t) + torch.einsum("ps,qr->pqrs", db_t, db_t)
    g += 0.5 * eri_grad(layout, Gamma).cpu().numpy()
    return g
