"""Full TDHF/RPA (A, B) pencil response: dense builders and the Casida solve.

Counterpart of the JAX package's `response/tdhf.py`.  For real orbitals the
B matrix reuses the TDA coupling tensors with an index transpose,
(ib|ja) = (ia|jb).permute(0, 3, 2, 1), and the same adiabatic fxc coupling,
so it needs no new integral work.  The Casida solve symmetrizes the pencil:
with S = A - B positive definite (a stable reference),
M = S^{1/2} (A + B) S^{1/2} is symmetric positive and M Z = w^2 Z gives w
and (X+Y), (X-Y) with <X+Y|X-Y> = 1.  A non-definite S raises
`RPAInstabilityError` (an external instability) instead of returning complex
roots.

Every matrix is built on the Env's device in its dtype (f64), as
`response/dense.py` builds A, and both ``eigh`` calls run there.  Layouts
are the TDA drivers': closed shell (nocc*nvir), unrestricted and
spin-adapted blocked CV(a)|OV(a)|CO(b)|CV(b).
"""

from __future__ import annotations

import numpy as np
import torch

from xtddft_tpu_torch.response import dense as _d
from xtddft_tpu_torch.response.fxc_tensor import fxc_blocks
from xtddft_tpu_torch.response.moeri import mo_eri
from xtddft_tpu_torch.response.reference_state import Reference
from xtddft_tpu_torch.response.sigma import _rho0
from xtddft_tpu_torch.response.spaces import order_interleaved2blocked


def _coulomb_iajb(ref: Reference, co1, cv1, co2, cv2) -> torch.Tensor:
    """(i1 a1 | j2 b2) Coulomb-type MO tensor."""
    return mo_eri(ref.env.eri, co1, cv1, co2, cv2)


def _exchange_ibja(ref: Reference, co, cv) -> torch.Tensor:
    """hyb (ib|ja) + (alpha - hyb) (ib|ja)_omega as an (i, a, j, b) tensor:
    the (ia|jb) tensor with a and b swapped, RSH mixing as `dense._k_eri`."""
    m = ref.hyb * mo_eri(ref.env.eri, co, cv, co, cv)
    if ref.omega != 0.0 and abs(ref.alpha - ref.hyb) > 1e-12:
        m = m + (ref.alpha - ref.hyb) * mo_eri(ref.env.eri_omega(ref.omega), co, cv, co, cv)
    return m.permute(0, 3, 2, 1)


def tdhf_b_blocks(ref: Reference):
    """(baa, bab, bbb) 4-index tensors of the RPA B coupling matrix (no Fock
    terms; B has none): B_ia,jb = (ia|jb) - cx (ib|ja) + fxc, exchange only
    in the same-spin blocks."""
    oa, va = ref.env.tensor(ref.orbo_a), ref.env.tensor(ref.orbv_a)
    ob, vb = ref.env.tensor(ref.orbo_b), ref.env.tensor(ref.orbv_b)
    baa = _coulomb_iajb(ref, oa, va, oa, va) - _exchange_ibja(ref, oa, va)
    bbb = _coulomb_iajb(ref, ob, vb, ob, vb) - _exchange_ibja(ref, ob, vb)
    bab = _coulomb_iajb(ref, oa, va, ob, vb)
    if ref.spec is not None and ref.spec.components:
        env = ref.env
        faa, fab, fbb = fxc_blocks(ref.spec, env.ao, env.grid_weights, _rho0(ref),
                                   (oa, va), (ob, vb), same=_d._same_orbitals(ref))
        baa = baa + faa.reshape(baa.shape)
        bab = bab + fab.reshape(bab.shape)
        bbb = bbb + fbb.reshape(bbb.shape)
    return baa, bab, bbb


def rtdhf_dense(ref: Reference, singlet: bool = True):
    """Closed-shell (A, B): A from the TDA builders, B from `tdhf_b_blocks`
    in its singlet (aa + ab) or triplet (aa - ab) combination."""
    A = _d.tda_singlet_dense(ref) if singlet else _d.tda_triplet_dense(ref)
    baa, bab, _ = tdhf_b_blocks(ref)
    n = baa.shape[0] * baa.shape[1]
    B = (baa + bab) if singlet else (baa - bab)
    return A, B.reshape(n, n)


def blocked_b(ref: Reference) -> torch.Tensor:
    """The RPA B matrix in the blocked CV(a)|OV(a)|CO(b)|CV(b) layout (that
    of `dense.utda_dense`/`dense.xtda_dense`; the beta part is permuted from
    the natural row-major ov order by `spaces.order_interleaved2blocked`)."""
    baa, bab, bbb = tdhf_b_blocks(ref)
    na = baa.shape[0] * baa.shape[1]
    nb = bbb.shape[0] * bbb.shape[1]
    B = torch.zeros((na + nb, na + nb), dtype=baa.dtype, device=baa.device)
    B[:na, :na] = baa.reshape(na, na)
    B[:na, na:] = bab.reshape(na, nb)
    B[na:, :na] = B[:na, na:].T
    B[na:, na:] = bbb.reshape(nb, nb)
    perm = torch.as_tensor(order_interleaved2blocked(ref.nc, ref.no, ref.nv), device=B.device)
    return B[perm][:, perm]


def utdhf_dense(ref: Reference):
    """Unrestricted (A, B) in the blocked layout."""
    return _d.utda_dense(ref), blocked_b(ref)


def xtdhf_dense(ref: Reference):
    """Spin-adapted X-TDHF (A, B) on a restricted-open reference: A is the
    X-TDA matrix with its dA terms; B is the bare coupling `blocked_b`, with
    no dA analog (the dA terms are one-electron couplings between single
    excitations, and a B element couples to doubles, where Slater-Condon
    leaves no one-electron part)."""
    if not ref.restricted_open:
        raise ValueError("xtdhf_dense requires a ROKS/ROHF reference")
    return _d.xtda_dense(ref), blocked_b(ref)


class RPAInstabilityError(RuntimeError):
    """A - B is not positive definite: the reference is externally unstable
    and the RPA pencil has non-real roots."""


def solve_casida(A, B, nroots: int, pos_threshold: float = 1e-6):
    """The lowest ``nroots`` roots of [[A, B], [B, A]] [X, Y] = w [X, -Y] for
    real orbitals, by the symmetrized form, on A's device (tensors or host
    arrays; f64).

    Returns host (w, xpy, xmy): the excitation energies and (X+Y), (X-Y) as
    (dim, nroots) columns with <X+Y|X-Y> = 1.  Roots below ``pos_threshold``
    (the zero-frequency spin rotation of an open-shell reference) are
    skipped, as the matrix-free solver skips them; exact zero modes of
    A - B are projected out."""
    A = torch.as_tensor(A)
    B = torch.as_tensor(B, dtype=A.dtype, device=A.device)
    S = A - B
    ws, Us = torch.linalg.eigh(0.5 * (S + S.T))
    ws_np = ws.cpu().numpy()
    if ws_np.min() < -1e-9:
        raise RPAInstabilityError(
            f"A-B has lowest eigenvalue {ws_np.min():.3e} < 0: reference is "
            "externally unstable (run stability analysis / relax the SCF)")
    keep = torch.as_tensor(ws_np > max(1e-10, float(ws_np.max()) * 1e-14), device=ws.device)
    Uk = Us[:, keep]
    sk = torch.sqrt(ws[keep])
    P = Uk * sk[None, :]   # S^{1/2} on its range
    Pm = Uk / sk[None, :]  # S^{-1/2} on its range
    M = P.T @ (A + B) @ P
    w2, Z = torch.linalg.eigh(0.5 * (M + M.T))
    w = torch.sqrt(torch.clamp(w2, min=0.0))
    if pos_threshold > 0.0:
        sel = w > pos_threshold
        w, Z = w[sel], Z[:, sel]
    n = min(nroots, w.shape[0])
    w, Z = w[:n], Z[:, :n]
    sw = torch.sqrt(torch.where(w > 0, w, torch.ones_like(w)))
    xpy = P @ Z / sw[None, :]
    xmy = Pm @ Z * sw[None, :]
    return w.cpu().numpy(), xpy.cpu().numpy(), xmy.cpu().numpy()
