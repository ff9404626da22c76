"""SO-DKH1 spin-orbit mean-field (SOMF) Vso builder.

Counterpart of the JAX package's `soc/somf.py`, a re-derivation of
`x2c_hamiltonian/sfX2C_soDKH1.py:692-852` (`get_soDKH1_somf`): the
3-component AO spin-orbit matrix

    Vso = (alpha^2/4) * (hso1e + fso2e)

with hso1e from the one-electron Wso integrals picture-changed by X/R+,
and fso2e from the mean-field contraction of the derivative-ERI tensor K
with the spin-averaged large/small densities (Mol. Phys. 111, 3741,
Eqs. 34-53).  iop='x2c' uses the sfX2C decoupling; iop='bp' is the
Breit-Pauli limit (X=R+=1).

The two-electron term streams the SO integrals a class of shell quartets
at a time (`ints/soc_ints.py kint_class_blocks`) and accumulates the three
Gso matrices from each chunk on the device, so the 3 nao^4 tensor is never
formed ('direct'); 'full', asked for by name, contracts the materialized
host tensor.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from xtddft_tpu_torch import config, units
from xtddft_tpu_torch.ints import kinetic, nuclear_attraction, overlap, soc_ints
from xtddft_tpu_torch.ints.soc_ints import nuclear_deriv2
from xtddft_tpu_torch.soc import x2c as x2c_mod


def fso2e_contract(kint, x, rp, pLL, pLS, pSS):
    """Mean-field 2e SO contraction (`sfX2C_soDKH1.py:257-292`, Eq. 42):
    fso2e = R+^T [GsoLL + GsoLS X + X^T(-GsoLS^T) + X^T GsoSS X] R+."""
    nb = x.shape[0]
    out = np.zeros((3, nb, nb))
    for ic in range(3):
        k = kint[ic]
        gsoLL = -2.0 * np.einsum("lmkn,lk->mn", k, pSS)
        gsoLS = -np.einsum("mlkn,lk->mn", k, pLS)
        gsoLS -= np.einsum("lmkn,lk->mn", k, pLS)
        gsoSS = -2.0 * np.einsum("mnkl,lk->mn", k, pLL)
        gsoSS -= 2.0 * np.einsum("mnlk,lk->mn", k, pLL)
        gsoSS += 2.0 * np.einsum("mlnk,lk->mn", k, pLL)
        out[ic] = _dress(gsoLL, gsoLS, gsoSS, x, rp)
    return out


def _dress(gsoLL, gsoLS, gsoSS, x, rp):
    f = gsoLL + gsoLS @ x + x.T @ (-gsoLS.T) + x.T @ (gsoSS @ x)
    return rp.T @ f @ rp


def _accumulate(G, t, ia, ib, ic, id_, pLL, pLS, pSS):
    """Add one chunk's blocks t[q, l, a, b, c, d] to the Gso matrices G (3
    [LL, LS, SS], 3, nb * nb): the six terms of `fso2e_contract`, each
    density block gathered per quartet and each product scattered back."""
    nb = pLL.shape[0]

    def gather(M, r, c):
        return M[r[:, :, None], c[:, None, :]]

    def add(g, r, c, v):
        idx = (r[:, :, None] * nb + c[:, None, :]).reshape(-1)
        G[g].index_add_(1, idx, v.permute(1, 0, 2, 3).reshape(3, -1))

    add(0, ib, id_, -2.0 * torch.einsum("qlabcd,qac->qlbd", t, gather(pSS, ia, ic)))  # lmkn,lk
    add(1, ia, id_, -torch.einsum("qlabcd,qbc->qlad", t, gather(pLS, ib, ic)))  # mlkn,lk
    add(1, ib, id_, -torch.einsum("qlabcd,qac->qlbd", t, gather(pLS, ia, ic)))  # lmkn,lk
    add(2, ia, ib, -2.0 * torch.einsum("qlabcd,qdc->qlab", t, gather(pLL, id_, ic)))  # mnkl,lk
    add(2, ia, ib, -2.0 * torch.einsum("qlabcd,qcd->qlab", t, gather(pLL, ic, id_)))  # mnlk,lk
    add(2, ia, ic, 2.0 * torch.einsum("qlabcd,qbd->qlac", t, gather(pLL, ib, id_)))  # mlnk,lk


def fso2e_direct(layout, x, rp, pLL, pLS, pSS, use_1c: bool = True, device=None):
    """Streaming fso2e: ``fso2e_contract(soc_ints.kint(...), ...)`` without
    the 3 nao^4 tensor (the reference's 'direct'/'block-par' impls,
    `sfX2C_soDKH1.py:65-141`): each chunk of quartet blocks, and each
    block's quartet-swap mirror, is contracted with the densities on
    ``device`` (default: the card) as it comes."""
    device, _ = config.resolve(device)
    nb = x.shape[0]
    P = [torch.as_tensor(np.asarray(m), device=device, dtype=torch.float64)
         for m in (pLL, pLS, pSS)]
    G = torch.zeros((3, 3, nb * nb), device=device, dtype=torch.float64)
    for ch in soc_ints.kint_class_blocks(layout, use_1c=use_1c, device=device):
        rows = [torch.as_tensor(r, device=device) for r in (ch.ia, ch.ib, ch.ic, ch.id)]
        _accumulate(G, ch.t, *rows, *P)
        if ch.mirror.any():
            m = torch.as_tensor(ch.mirror, device=device)
            ia, ib, ic, id_ = (r[m] for r in rows)
            _accumulate(G, -ch.t[m].permute(0, 1, 4, 5, 2, 3), ic, id_, ia, ib, *P)
    G = G.reshape(3, 3, nb, nb).cpu().numpy()
    return np.stack([_dress(G[0, ic], G[1, ic], G[2, ic], x, rp) for ic in range(3)])


def resolve_mf2e_impl(nao: int, impl: str = "auto") -> str:
    """'full' (materialize the 3*nao^4 K tensor on the host) or 'direct'
    (streaming, O(nao^2) accumulators).  'auto' is 'direct': the streaming
    contraction runs on the device a class of quartets at a time, where the
    JAX package's loops over single quartets made 'full' its fast path
    (`sfX2C_soDKH1.py:119-141`).  ``nao`` is kept for the JAX signature."""
    if impl == "auto":
        return "direct"
    if impl not in ("full", "direct"):
        raise ValueError(f"mf2e_impl={impl!r} not in ('auto', 'full', 'direct')")
    return impl


@dataclasses.dataclass
class VsoResult:
    vso: np.ndarray  # (3, nao, nao) in the contracted AO basis
    hso1e: np.ndarray  # uncontracted-basis pieces (for diagnostics)
    fso2e: np.ndarray | None
    x: np.ndarray
    rp: np.ndarray
    seconds: dict | None = None  # "x2c" (the decoupling), "1e", "2e"


def build_vso(mf, iop: str = "x2c", include_mf2e: bool = True,
              use_1c: bool = True, c: float = units.C_AU,
              mf2e_impl: str = "auto", device=None) -> VsoResult:
    """AO-basis SOMF spin-orbit matrix Vso (3, nao, nao), antisymmetric per
    component.  ``mf`` is a converged MeanField (any flavor).  The streaming
    2e term runs on ``device`` (default: the mean field's Env's).

    mf2e_impl: 'auto' and 'direct' stream the 2e term; 'full' forms the K
    tensor on the host (`resolve_mf2e_impl`)."""
    env = mf.env
    device = env.device if device is None else device
    layout = env.layout
    t0 = time.perf_counter()
    unc, contr = x2c_mod.uncontract(layout)
    w_sf, w_so = nuclear_deriv2(unc)
    t1 = time.perf_counter()
    if iop == "x2c":
        x, rp, _ = x2c_mod.sfx2c1e(kinetic(unc), nuclear_attraction(unc), w_sf, overlap(unc), c)
    elif iop == "bp":
        x = np.eye(unc.nao)
        rp = np.eye(unc.nao)
    else:
        raise ValueError(f"iop={iop!r} not in ('x2c', 'bp')")
    t2 = time.perf_counter()

    dm = np.asarray(mf.make_rdm1())
    dm = 0.5 * (dm[0] + dm[1]) if dm.ndim == 3 else 0.5 * dm
    dm_unc = contr @ dm @ contr.T
    pLL, pLS, pSS = x2c_mod.get_p(dm_unc, x, rp)

    a4 = 0.25 / c**2
    hso1e = np.stack([rp.T @ x.T @ w_so[ic] @ x @ rp for ic in range(3)])
    vso = a4 * hso1e.copy()
    t3 = time.perf_counter()
    fso2e = None
    if include_mf2e:
        if resolve_mf2e_impl(unc.nao, mf2e_impl) == "full":
            fso2e = fso2e_contract(soc_ints.kint(unc, use_1c=use_1c, device=device),
                                   x, rp, pLL, pLS, pSS)
        else:
            fso2e = fso2e_direct(unc, x, rp, pLL, pLS, pSS, use_1c=use_1c, device=device)
        vso += a4 * fso2e
    vso_contr = np.stack([contr.T @ vso[ic] @ contr for ic in range(3)])
    seconds = {"x2c": t2 - t1, "1e": (t1 - t0) + (t3 - t2), "2e": time.perf_counter() - t3}
    return VsoResult(vso=vso_contr, hso1e=hso1e, fso2e=fso2e, x=x, rp=rp, seconds=seconds)
