"""Block Davidson with the subspace basis on the device.

Counterpart of the JAX package's fused solver (`solver/davidson_jit.py`
`_build_fulljit_solver` / `davidson_fulljit`), with the same semantics:

- expansion by two-pass projection against V plus CholeskyQR2;
- the generalized pencil (H, S) solved by canonical orthogonalization,
  dropped near-dependent directions shifted above the spectrum;
- ``pick_positive`` moves Ritz values below ``pos_threshold`` to the shift;
- restart from the current Ritz pairs when the space is full;
- convergence is the residual test only; 4 cycles without a 2% drop of
  the largest unconverged residual end the loop with those roots
  unconverged.

V and AV live on the operator's device in its dtype.  The projections
H = V AV^T and S = V V^T are formed there; the small pencil is solved on
the host in f64 (numpy) every cycle, for f32 and f64 operators alike.
"""

from __future__ import annotations

import numpy as np
import torch


def _max_space(dim: int, nb: int, max_space_factor: int) -> int:
    cap = max(nb, nb * max_space_factor)
    if cap >= dim:
        # small problems: whole space reachable; at least two blocks so a
        # post-restart expansion never overwrites the restart basis
        return max(2 * nb, nb * (-(-dim // nb)))
    return nb * (cap // nb)


def davidson(matvec, hdiag, nroots: int = 5, init_guess=None,
             tol: float | None = None, max_cycle: int = 60,
             max_space_factor: int = 12, pick_positive: bool = False,
             pos_threshold: float = 1e-3, device=None, dtype=None):
    """Lowest eigenpairs of the operator ``matvec`` ((nb, dim) tensor ->
    (nb, dim) tensor).

    The block size is the number of rows of ``init_guess`` (default: unit
    vectors on the ``nroots`` lowest diagonal entries).  ``device``/``dtype``
    default to those of the operator, read from one probe matvec (the
    operator computes on its own device, so None never picks the CPU by
    itself); ``tol=None`` picks 1e-6 for f64
    and 3e-4 for f32.  Returns (e (nroots,), v (dim, nroots), conv
    (nroots,), info) with numpy arrays and info = {"cycles", "matvecs"}.
    """
    hdiag_np = np.asarray(hdiag, dtype=np.float64)
    dim = hdiag_np.shape[0]
    nroots = min(nroots, dim)
    if init_guess is None:
        idx = np.argsort(hdiag_np)[:nroots]
        init_guess = np.zeros((nroots, dim))
        init_guess[np.arange(nroots), idx] = 1.0
    init_guess = np.asarray(init_guess)
    nb = init_guess.shape[0]
    max_space = _max_space(dim, nb, max_space_factor)

    if device is None or dtype is None:
        probe = matvec(torch.as_tensor(init_guess, device=device, dtype=dtype))
        device = probe.device if device is None else device
        dtype = probe.dtype if dtype is None else dtype
    if tol is None:
        tol = 1e-6 if dtype == torch.float64 else 3e-4
    hdiag_d = torch.as_tensor(hdiag_np, dtype=dtype, device=device)
    V = torch.zeros((max_space, dim), dtype=dtype, device=device)
    AV = torch.zeros((max_space, dim), dtype=dtype, device=device)
    eye = torch.eye(nb, dtype=dtype, device=device)
    ns = 0
    nmv = 0

    def expand(X):
        nonlocal ns, nmv
        Vs = V[:ns]
        X = X - (X @ Vs.T) @ Vs
        X = X - (X @ Vs.T) @ Vs
        for _ in range(2):  # CholeskyQR2
            # the shift scales with each pass's own rows: after the first
            # pass they are of unit norm, and rows left dependent (a space
            # smaller than the block, or exhausted) must not break the
            # second factorization; the pencil drops them (``ritz``)
            eps = 1e-10 * torch.max(torch.sum(X * X, dim=1)) + 1e-30
            L = torch.linalg.cholesky(X @ X.T + eps * eye)
            X = torch.linalg.solve_triangular(L, X, upper=False)
        V[ns:ns + nb] = X
        AV[ns:ns + nb] = matvec(X)
        ns += nb
        nmv += nb

    def ritz():
        Vs, AVs = V[:ns], AV[:ns]
        H = (Vs @ AVs.T).cpu().numpy().astype(np.float64)
        S = (Vs @ Vs.T).cpu().numpy().astype(np.float64)
        H = 0.5 * (H + H.T)
        S = 0.5 * (S + S.T)
        ws, Us = np.linalg.eigh(S)
        valid = ws > 1e-5
        Xc = Us * np.where(valid, 1.0 / np.sqrt(np.where(valid, ws, 1.0)), 0.0)[None, :]
        # the shift for dropped directions stays within a few orders of
        # the spectrum, so it costs the pencil no precision
        shift = 10.0 * (1.0 + np.max(np.abs(H)))
        w, sc = np.linalg.eigh(Xc.T @ H @ Xc + np.diag(np.where(valid, 0.0, shift)))
        if pick_positive:
            w = np.where(w > pos_threshold, w, shift)
            order = np.argsort(w, kind="stable")
            w, sc = w[order], sc[:, order]
        s = torch.as_tensor(Xc @ sc[:, :nb], dtype=dtype, device=device)
        e = torch.as_tensor(w[:nb], dtype=dtype, device=device)
        xs = s.T @ Vs
        ax = s.T @ AVs
        r = ax - e[:, None] * xs
        return e, xs, ax, r, torch.sum(r * r, dim=1)

    X = torch.as_tensor(init_guess, dtype=dtype, device=device)
    conv = np.zeros(nb, dtype=bool)
    e = xs = None
    stall = 0
    rmax_prev = np.float32(np.inf)
    cycle = 0
    while cycle < max_cycle and not conv.all() and stall < 4:
        if ns + nb > max_space:
            # restart: the current Ritz pairs become the fresh basis
            _, xs0, ax0, _, _ = ritz()
            V.zero_()
            AV.zero_()
            V[:nb] = xs0
            AV[:nb] = ax0
            ns = nb
        expand(X)
        e, xs, ax, r, rnorm2 = ritz()
        rnorm = np.sqrt(np.maximum(rnorm2.cpu().numpy(), 0.0))
        conv = rnorm < tol
        # progress is tracked in f32 whatever the operator dtype
        rmax = np.float32(np.max(np.where(conv, 0.0, rnorm)))
        stall = 0 if (conv.all() or rmax < np.float32(0.98) * rmax_prev) else stall + 1
        if rmax > 0:
            rmax_prev = min(rmax_prev, rmax)
        denom = hdiag_d[None, :] - e[:, None]
        denom = torch.where(denom.abs() < 1e-8, torch.full_like(denom, 1e-8), denom)
        X = r / denom
        cycle += 1

    e_np = e.cpu().numpy()[:nroots] if e is not None else np.zeros(nroots)
    v_np = xs.cpu().numpy()[:nroots].T if xs is not None else np.zeros((dim, nroots))
    return e_np, v_np, conv[:nroots], {"cycles": cycle, "matvecs": nmv}
