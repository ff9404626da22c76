"""A plain block Davidson for the lowest eigenpairs of a symmetric operator.

The basis and its images live on the operator's device in its dtype; the
projected matrix is solved on the host in f64.  Textbook steps: Rayleigh-
Ritz in the basis, residuals, diagonal (Davidson) preconditioning of the
unconverged residuals, two Gram-Schmidt passes and a QR against the
basis, and a restart from the Ritz vectors when the basis is full.
"""

from __future__ import annotations

import numpy as np
import torch


POS_THRESHOLD = 1e-3  # the Ritz values ``pick_positive`` passes over, as the port's
MAX_BLOCKS = 8        # the basis holds this many blocks before a restart


def lowest(apply, diag: np.ndarray, nroots: int, tol: float, dtype, device,
           pick_positive: bool = False, extra: int = 4, max_iter: int = 200, record=None):
    """(e (nroots,), X (nroots, dim) tensor, converged (nroots,) bool).

    ``apply``: (n, dim) tensor -> (n, dim) tensor.  The block carries
    ``extra`` more vectors than roots.  ``pick_positive`` passes over Ritz
    values at or below POS_THRESHOLD.  ``record(z, az)``, when given,
    sees every product the solve makes."""
    dim = diag.shape[0]
    nb = min(nroots + extra, dim)
    d = torch.as_tensor(diag, dtype=dtype, device=device)
    X = torch.zeros((nb, dim), dtype=dtype, device=device)
    X[torch.arange(nb), torch.as_tensor(np.argsort(diag, kind="stable")[:nb], device=device)] = 1
    V = torch.zeros((0, dim), dtype=dtype, device=device)
    AV = torch.zeros_like(V)
    conv = np.zeros(nroots, dtype=bool)
    for _ in range(max_iter):
        for _ in range(2):
            X = X - (X @ V.T) @ V
        Q, R = torch.linalg.qr(X.T)
        keep = torch.abs(torch.diagonal(R)) > 1e-8 * torch.abs(torch.diagonal(R)).max()
        X = Q.T[keep]
        if X.shape[0] == 0:
            break
        AX = apply(X)
        if record is not None:
            record(X, AX)
        V, AV = torch.cat([V, X]), torch.cat([AV, AX])
        H = (V @ AV.T).double().cpu().numpy()
        w, c = np.linalg.eigh(0.5 * (H + H.T))
        order = np.argsort(np.where(w > POS_THRESHOLD, w, np.inf), kind="stable") \
            if pick_positive else np.arange(w.size)
        w, c = w[order][:nb], c[:, order][:, :nb]
        C = torch.as_tensor(c, dtype=dtype, device=device)
        xs, axs = C.T @ V, C.T @ AV
        r = axs - torch.as_tensor(w, dtype=dtype, device=device)[:, None] * xs
        rn = torch.linalg.norm(r, dim=1).double().cpu().numpy()
        conv = rn[:nroots] < tol
        if conv.all():
            break
        todo = np.where(rn >= tol)[0]
        den = d[None, :] - torch.as_tensor(w[todo], dtype=dtype, device=device)[:, None]
        den = torch.where(den.abs() < 1e-8, torch.full_like(den, 1e-8), den)
        X = r[torch.as_tensor(todo, device=device)] / den
        if V.shape[0] + X.shape[0] > MAX_BLOCKS * nb:
            V, AV = xs, axs
    return w[:nroots], xs[:nroots], conv
