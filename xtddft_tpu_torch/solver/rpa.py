"""Paired-subspace Davidson for the RPA pencil over matrix-free (A z, B z).

Counterpart of the JAX package's `solver/rpa.py` (`_subspace_solve`,
`rpa_rayleigh_ritz`, `rpa_davidson`).  It solves [[A,B],[B,A]] (X,Y) =
w (X,-Y) without forming A or B: for real orbitals and a stable reference
(A - B positive definite) the paired equations are

    (A+B)(X+Y) = w (X-Y),      (A-B)(X-Y) = w (X+Y),

so in an orthonormal trial space V the projected pencil Hp = V^T(A+B)V,
Hm = V^T(A-B)V (both symmetric positive definite) gives w^2 as the
eigenvalues of Hm^{1/2} Hp Hm^{1/2}, and X+Y = V Hm^{1/2} y / sqrt(w),
X-Y = V Hm^{-1/2} y sqrt(w), normalized to <X+Y|X-Y> = 1 (the convention of
`response/tdhf.solve_casida`).  Each cycle adds both preconditioned
residuals r+ = (A+B)(X+Y) - w(X-Y) and r- = (A-B)(X-Y) - w(X+Y) to the
space (Stratmann, Scuseria and Frisch, J. Chem. Phys. 109, 8218 (1998)).

V, AV and BV live on the operator's device in its dtype; the projected
pencil is solved on the host in f64 every cycle, as `solver/davidson.py`
does.  The JAX package's one-dispatch `rpa_fulljit` is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from xtddft_tpu_torch.response.tdhf import RPAInstabilityError

__all__ = ["rpa_davidson", "rpa_rayleigh_ritz"]


def _subspace_solve(Hp: np.ndarray, Hm: np.ndarray, nroots: int,
                    pos_threshold: float = 0.0):
    """Dense solve of the projected RPA pencil (host f64); returns (w, c+, c-).

    pos_threshold > 0 skips marginal and zero-frequency modes (w below it,
    e.g. rotations among degenerate partially occupied orbitals), the
    pencil's counterpart of the TDA Davidson's pick_positive."""
    wm, Um = np.linalg.eigh(0.5 * (Hm + Hm.T))
    if wm.min() < -1e-9 * max(1.0, abs(wm.max())):
        raise RPAInstabilityError(
            f"projected A-B has lowest eigenvalue {wm.min():.3e} < 0: "
            "reference is externally unstable (run stability analysis)")
    keep = wm > max(1e-12, float(wm.max()) * 1e-14)
    Uk = Um[:, keep]
    sk = np.sqrt(wm[keep])
    P = Uk * sk[None, :]   # Hm^{1/2} on its range
    Pm = Uk / sk[None, :]  # Hm^{-1/2}
    M = P.T @ Hp @ P
    w2, Z = np.linalg.eigh(0.5 * (M + M.T))
    w = np.sqrt(np.maximum(w2, 0.0))
    if pos_threshold > 0.0:
        sel = w > pos_threshold
        w, Z = w[sel], Z[:, sel]
    n = min(nroots, w.shape[0])
    w, Z = w[:n], Z[:, :n]
    sw = np.sqrt(np.where(w > 0, w, 1.0))
    return w, P @ Z / sw[None, :], Pm @ Z * sw[None, :]


def _pair(matvec_ab, X: torch.Tensor):
    """(dim, k) trial columns -> (A X, B X) columns."""
    out = matvec_ab(X.T.contiguous())
    return out[0].T, out[1].T


def _placement(matvec_ab, X, device, dtype):
    """(device, dtype) given, or else those of the operator, read from one
    probe matvec (the operator computes on its own device, so None never
    picks the CPU by itself)."""
    if device is None or dtype is None:
        probe = matvec_ab(torch.as_tensor(np.asarray(X[:, :1]).T))
        device = probe.device if device is None else device
        dtype = probe.dtype if dtype is None else dtype
    return device, dtype


def rpa_rayleigh_ritz(matvec_ab, V, nroots: int, pos_threshold: float = 0.0,
                      device=None, dtype=None):
    """One projected RPA solve in the orthonormal basis ``V`` (dim, m):
    returns host (w, X+Y, X-Y) full-space vectors.  ``matvec_ab``: (n, dim)
    -> (2, n, dim) [A z, B z] on ``device`` (default: the operator's own);
    raises `RPAInstabilityError` where the projected A - B is not positive
    definite."""
    device, dtype = _placement(matvec_ab, V, device, dtype)
    V = torch.as_tensor(V, dtype=dtype, device=device)
    AV, BV = _pair(matvec_ab, V)
    Hp = (V.T @ (AV + BV)).cpu().numpy().astype(np.float64)
    Hm = (V.T @ (AV - BV)).cpu().numpy().astype(np.float64)
    w, cp, cm = _subspace_solve(Hp, Hm, nroots, pos_threshold=pos_threshold)
    Vn = V.cpu().numpy().astype(np.float64)
    return w, Vn @ cp, Vn @ cm


def _complement(T: torch.Tensor, V: torch.Tensor, lindep: float) -> torch.Tensor:
    """The columns of T made orthonormal and orthogonal to V.  Each column is
    scaled to unit norm first, and one whose norm falls below ``lindep``
    after two Gram-Schmidt passes against V, or whose pivot in the QR of the
    survivors does, is dropped; the kept ones are projected once more after
    that QR, which re-admits components along V where columns are nearly
    dependent (the JAX package's drop, relative to the largest pivot at an
    absolute 1e-13, kept such columns and let V lose its orthogonality: 5e-6
    at FH/6-31G RHF in the U space, with a root stuck at 4e-7)."""
    T = T / torch.linalg.norm(T, dim=0).clamp_min(torch.finfo(T.dtype).tiny)
    for _ in range(2):
        T = T - V @ (V.T @ T)
    T = T[:, torch.linalg.norm(T, dim=0) > lindep]
    if T.shape[1] == 0:
        return T
    q, r = torch.linalg.qr(T)
    q = q[:, torch.diagonal(r).abs() > lindep]
    q, _ = torch.linalg.qr(q - V @ (V.T @ q))
    return q


def rpa_davidson(matvec_ab, hdiag, nroots: int = 5, init_guess=None,
                 tol: float = 1e-6, max_cycle: int = 100, max_space_factor: int = 12,
                 lindep: float = 1e-10, pick_positive: bool = False,
                 pos_threshold: float = 1e-6, device=None, dtype=None):
    """Returns host (w (nroots,), xpy (dim, nroots), xmy (dim, nroots),
    conv (nroots,) bool, info {"cycles", "matvecs"}).

    matvec_ab: (n, dim) tensor -> (2, n, dim) stacked [A z, B z] (the
    ``with_b=True`` DF sigma) on ``device`` in ``dtype`` (default: the
    operator's own, read from one probe matvec).  hdiag: the
    orbital-energy-difference diagonal of A, also the preconditioner.
    Where ``pick_positive`` leaves fewer than ``nroots`` roots above
    ``pos_threshold`` and all of them have converged, fresh Koopmans
    directions are added; new directions below ``lindep`` (`_complement`)
    are dropped, and the space collapses to span(X+Y, X-Y) when full."""
    hdiag = np.array(hdiag, dtype=np.float64)
    dim = hdiag.shape[0]
    nroots = min(nroots, dim)
    if init_guess is None:
        idx = np.argsort(hdiag)[:nroots]
        init_guess = np.zeros((nroots, dim))
        init_guess[np.arange(nroots), idx] = 1.0
    X0 = np.asarray(init_guess, dtype=np.float64).T
    device, dtype = _placement(matvec_ab, X0, device, dtype)
    V, _ = torch.linalg.qr(torch.as_tensor(X0, dtype=dtype, device=device))
    max_space = max(2 * nroots * max_space_factor, V.shape[1] + 2)
    hdiag_d = torch.as_tensor(hdiag, dtype=dtype, device=device)
    AV = torch.zeros((dim, 0), dtype=dtype, device=device)
    BV = torch.zeros((dim, 0), dtype=dtype, device=device)
    w = np.zeros(nroots)
    conv = np.zeros(nroots, dtype=bool)
    xpy = xmy = torch.zeros((dim, nroots), dtype=dtype, device=device)
    cycles = nmv = 0
    for cycles in range(1, max_cycle + 1):
        nnew = V.shape[1] - AV.shape[1]
        if nnew > 0:
            A_new, B_new = _pair(matvec_ab, V[:, -nnew:])
            AV = torch.cat([AV, A_new], dim=1)
            BV = torch.cat([BV, B_new], dim=1)
            nmv += nnew
        Hp = (V.T @ (AV + BV)).cpu().numpy().astype(np.float64)
        Hm = (V.T @ (AV - BV)).cpu().numpy().astype(np.float64)
        try:
            w, cp, cm = _subspace_solve(Hp, Hm, nroots,
                                        pos_threshold=pos_threshold if pick_positive else 0.0)
        except np.linalg.LinAlgError:
            break
        cp_d = torch.as_tensor(cp, dtype=dtype, device=device)
        cm_d = torch.as_tensor(cm, dtype=dtype, device=device)
        w_d = torch.as_tensor(w, dtype=dtype, device=device)
        xpy = V @ cp_d
        xmy = V @ cm_d
        rp = (AV + BV) @ cp_d - xmy * w_d[None, :]
        rm = (AV - BV) @ cm_d - xpy * w_d[None, :]
        rn = torch.maximum(torch.linalg.norm(rp, dim=0), torch.linalg.norm(rm, dim=0))
        conv = rn.cpu().numpy() < tol
        # with pick_positive the early space may hold fewer than nroots
        # roots above the threshold: keep expanding then
        if conv.all() and w.shape[0] >= nroots:
            break
        if V.shape[1] + 2 * int((~conv).sum()) > max_space:
            # collapse to the current pair space, both components
            V, _ = torch.linalg.qr(torch.cat([xpy, xmy], dim=1))
            AV = AV[:, :0]
            BV = BV[:, :0]
            continue
        # the dual preconditioned expansion: one vector per residual
        denom = hdiag_d[:, None] - w_d[None, :]
        denom = torch.where(denom.abs() < 1e-8, torch.sign(denom + 1e-300) * 1e-8, denom)
        open_ = torch.as_tensor(~conv, device=device)
        new = [rp[:, open_] / denom[:, open_], rm[:, open_] / denom[:, open_]]
        if conv.all() and w.shape[0] < nroots:
            # every root found has converged but the threshold filtered the
            # space below nroots: seed fresh Koopmans directions
            k = nroots - w.shape[0] + 1
            extra = torch.zeros((dim, k), dtype=dtype, device=device)
            extra[torch.as_tensor(np.argsort(hdiag)[:k], device=device),
                  torch.arange(k, device=device)] = 1.0
            new.append(extra)
        q = _complement(torch.cat(new, dim=1), V, lindep)
        if q.shape[1] == 0:
            break
        V = torch.cat([V, q], dim=1)
    return (w, xpy.cpu().numpy(), xmy.cpu().numpy(), conv,
            {"cycles": cycles, "matvecs": nmv})
