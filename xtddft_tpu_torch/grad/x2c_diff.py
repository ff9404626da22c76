"""Differentiable sfX2C one-electron Hamiltonian (for analytic gradients).

Counterpart of the JAX package's `grad/x2c_diff.py`.  The host decoupling
(`soc/x2c.py sfx2c1e`) takes X from the positive-energy eigenvectors of the
2n x 2n problem; autodiff through ``eigh`` is not finite on the degenerate
eigenvalues every atom with p shells has.  Here the decoupling is written
with smooth spectral matrix functions only:

    X~  from the positive-spectrum projector P+ = (I + sign(H'))/2 of the
        metric-reduced Hamiltonian H' = m^{-1/2} h m^{-1/2}, shifted by c^2
        so that the gap between the two branches sits at 0,
    R+  from inverse square roots of SPD matrices,

each A -> U f(D) U^T an autograd function whose backward is the
Daleckii-Krein divided-difference kernel, (f(a)-f(b))/(a-b), or f'((a+b)/2)
on near-degenerate pairs: finite where the eigenvector derivative is not.
At the reference geometry it matches `soc/x2c.py sfx2c1e` to f64 round-off,
and through `ints/diffints.py` (with its pVp block) it is differentiable in
the nuclear coordinates.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_matfunc", "sfx2c1e_diff", "make_x2c_hcore_fn"]


def _dk_kernel(w, f, df):
    """Daleckii-Krein K_ij: (f(w_i) - f(w_j)) / (w_i - w_j), or
    df((w_i + w_j)/2) where |w_i - w_j| < 1e-9 max(|w|, 1)."""
    fw = f(w)
    dw = w[:, None] - w[None, :]
    scale = torch.clamp(w.abs().max(), min=1.0)
    near = dw.abs() < 1e-9 * scale
    return torch.where(near, df(0.5 * (w[:, None] + w[None, :])),
                       (fw[:, None] - fw[None, :]) / torch.where(near, torch.ones_like(dw), dw))


def make_matfunc(f, df, name: str = "matfunc"):
    """Smooth symmetric-matrix function A -> U f(D) U^T (f, df: the spectral
    function and its derivative, elementwise torch functions).  Its
    derivative is U (K o U^T sym(dA) U) U^T with K the Daleckii-Krein
    kernel; K is symmetric, so the adjoint is the same map, which the
    backward applies to the output's cotangent."""

    class _MatFunc(torch.autograd.Function):
        @staticmethod
        def forward(A):
            w, U = torch.linalg.eigh(A)
            return (U * f(w)[None, :]) @ U.T, w, U

        @staticmethod
        def setup_context(ctx, inputs, output):
            _, w, U = output
            ctx.save_for_backward(w, U)
            ctx.mark_non_differentiable(w, U)

        @staticmethod
        def backward(ctx, g, _gw, _gU):
            w, U = ctx.saved_tensors
            gs = U.T @ (0.5 * (g + g.T)) @ U
            return U @ (_dk_kernel(w, f, df) * gs) @ U.T

    def matfunc(A):
        return _MatFunc.apply(A)[0]

    matfunc.__name__ = name
    return matfunc


_invsqrt = make_matfunc(lambda w: 1.0 / torch.sqrt(torch.clamp(w, min=1e-14)),
                        lambda w: -0.5 * torch.clamp(w, min=1e-14) ** (-1.5), "invsqrt")
_sqrtm = make_matfunc(lambda w: torch.sqrt(torch.clamp(w, min=0.0)),
                      lambda w: 0.5 / torch.sqrt(torch.clamp(w, min=1e-14)), "sqrtm")
_sign = make_matfunc(torch.sign, torch.zeros_like, "matsign")


def sfx2c1e_diff(t, v, w, s, c):
    """One-step sfX2C picture-changed h1e, smooth in (t, v, w, s): the math
    of `soc/x2c.py sfx2c1e` (JCP 137, 154114 Eqs. 38-48) with the
    eigenvector extraction replaced by projector algebra.  Returns the
    n x n h1e in the basis the integrals are given in."""
    n = s.shape[0]
    m22 = t * (0.5 / c ** 2)
    h22 = w * (0.25 / c ** 2) - t
    s_ih = _invsqrt(s)
    t_ih = _invsqrt(m22)
    Hp = torch.cat([torch.cat([s_ih @ v @ s_ih, s_ih @ t @ t_ih], dim=1),
                    torch.cat([t_ih @ t @ s_ih, t_ih @ h22 @ t_ih], dim=1)], dim=0)
    Hp = 0.5 * (Hp + Hp.T)
    # positronic solutions sit near -2c^2, electronic ones well above -c^2:
    # a shift by +c^2 puts the gap at 0, where sign() splits the branches
    eye = torch.eye(2 * n, dtype=s.dtype, device=s.device)
    P = 0.5 * (eye + _sign(Hp + (c * c) * eye))
    P11 = P[:n, :n]
    P21 = P[n:, :n]
    Xt = torch.linalg.solve(P11.T, P21.T).T  # X~ = Ys Yl^{-1}
    s_h = _sqrtm(s)
    X = t_ih @ Xt @ s_h  # back to the non-orthogonal basis
    stilde = s + X.T @ (m22 @ X)
    rp = s_ih @ _invsqrt(s_ih @ stilde @ s_ih) @ s_h
    l1e = v + t @ X + X.T @ t + X.T @ (h22 @ X)
    h1e = rp.T @ l1e @ rp
    return 0.5 * (h1e + h1e.T)


def make_x2c_hcore_fn(layout, c: float):
    """Differentiable ``hcore(coords) -> (nao, nao)`` of an sfX2C reference:
    the uncontracted basis's S/T/V/pVp from `ints/diffints.py`, the smooth
    decoupling, and the contraction back to the computational basis.  At
    the reference geometry it matches `Env.hcore` with ``x2c``."""
    from xtddft_tpu_torch.ints import diffints as D
    from xtddft_tpu_torch.soc.x2c import uncontract

    unc, contr = uncontract(layout)
    classes = D._pair_classes(unc)
    charges = np.asarray(unc.mol.charges, dtype=np.float64)
    nao_u = unc.nao

    def hcore(coords):
        S, T, V, W = (coords.new_zeros((nao_u, nao_u)) for _ in range(4))
        for pc in classes:
            S_blk, T_blk = D._overlap_kinetic(pc, coords)
            S = D._scatter2(S, pc, S_blk)
            T = D._scatter2(T, pc, T_blk)
            V = D._scatter2(V, pc, D._nuclear(pc, coords, charges))
            W = D._scatter2(W, pc, D._pvp(pc, coords, charges))
        h1e = sfx2c1e_diff(T, V, W, S, c)
        ct = torch.as_tensor(contr, dtype=coords.dtype, device=coords.device)
        return ct.T @ h1e @ ct

    return hcore
