"""Dense fxc (ia|f|jb) tensors from pointwise Hessians of the energy density.

Counterpart of the JAX package's `response/fxc_tensor.py`: the weighted
Hessian of the energy density in the pointwise variables (ra, grad ra, rb,
grad rb), with (ta, tb) for a meta-GGA, is contracted against
occupied-virtual pair features, which is exact for every family (the tau
channel is one more feature, 1/2 grad phi_i . grad phi_a).  The Hessian comes from ``torch.func`` (the
points are independent, so column b of the summed energy's Hessian is one
jvp of its gradient along direction b on every point at once, the eight
columns one ``vmap`` over the directions); each block
is then one matrix product per chunk of 4096 points over the chunk's pair
features (4, gc, no*nv), which are never formed for the whole grid (benzene
cc-pVDZ: 256 MB a chunk in f64, 18.4 GB for its 294,480 points).
"""

from __future__ import annotations

import torch

from xtddft_tpu_torch.xc.interface import MASK_RHO, exc_density_fn
from xtddft_tpu_torch.xc.registry import XCSpec

# points per Hessian batch (8 jvps each)
HESSIAN_POINTS = 1 << 16
# grid points per chunk of the dense tensors (`fxc_blocks`, and
# `xc/mcol.sf_mcol_tensor`), as the JAX `fxc_blocks` chunks
DENSE_CHUNK = 4096


def weighted_hessian(spec: XCSpec, weights, rho0) -> torch.Tensor:
    """w * d^2 e / dx^2 per grid point (JAX `response/fxc_tensor.py:22`):
    x = (ra, gax, gay, gaz, rb, gbx, gby, gbz), (ng, 8, 8), and for a
    meta-GGA's 6-tuple x = (ra, gax, gay, gaz, ta, rb, ..., tb), (ng, 10,
    10)."""
    efn = exc_density_fn(spec)
    ra, rb, ga, gb, *taus = rho0
    dt, dev = ra.dtype, ra.device
    mask = (ra > MASK_RHO) | (rb > MASK_RHO)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    w = torch.where(mask, weights, zero)
    # a benign nonzero gradient on dummy points keeps the second derivatives
    # of sqrt(gamma) terms finite
    small = torch.full((), 1e-3, dtype=dt, device=dev)
    def spin(r, g, t):
        return ([torch.where(mask, r, one)[None], torch.where(mask[None], g, small)]
                + ([] if t is None else [torch.where(mask, t, one)[None]]))

    ta, tb = taus if taus else (None, None)
    X = torch.cat(spin(ra, ga, ta) + spin(rb, gb, tb))
    nx = X.shape[0]
    ns = nx // 2  # variables per spin

    def total(x):
        return torch.sum(efn(x[0], x[ns], x[1:4], x[ns + 1:ns + 4], *x[4::ns][:len(taus)]))

    grad = torch.func.grad(total)
    ng = X.shape[1]
    H = torch.empty((ng, nx, nx), dtype=dt, device=dev)
    for g0 in range(0, ng, HESSIAN_POINTS):
        x = X[:, g0:g0 + HESSIAN_POINTS]
        # the unit directions as one batch of tangents: the primal pass runs
        # once, not once per column
        tangents = torch.eye(nx, dtype=dt, device=dev)[:, :, None].expand(nx, nx, x.shape[1])
        cols = torch.func.vmap(lambda t: torch.func.jvp(grad, (x,), (t,))[1])(tangents)
        H[g0:g0 + HESSIAN_POINTS] = cols.permute(2, 1, 0)
    return H * w[:, None, None]


def mo_pair_features(ao_c, orb_o, orb_v, tau: bool = False) -> torch.Tensor:
    """(4, gc, no*nv): [phi_i phi_a, grad(phi_i phi_a)] of the (i, a) pairs
    on a chunk of points, ao_c (4, gc, nao), and with ``tau`` a fifth row,
    tau_ia = 1/2 grad phi_i . grad phi_a; the JAX `pair_features`
    (`response/fxc_tensor.py:67`) with the component axis first.  The
    builders form them a chunk at a time."""
    po = ao_c @ orb_o  # (4, gc, no)
    pv = ao_c @ orb_v
    gc = ao_c.shape[1]
    val = po[0][:, :, None] * pv[0][:, None, :]
    grad = po[1:4][:, :, :, None] * pv[0][None, :, None, :] \
        + po[0][None, :, :, None] * pv[1:4][:, :, None, :]
    feats = [val[None], grad]
    if tau:
        feats.append(0.5 * torch.einsum("ygi,yga->gia", po[1:4], pv[1:4])[None])
    return torch.cat(feats, dim=0).reshape(-1, gc, po.shape[2] * pv.shape[2])


def fxc_blocks(spec: XCSpec, ao, weights, rho0, orbs_a: tuple, orbs_b: tuple,
               chunk: int = DENSE_CHUNK, same: bool = False):
    """(f_aa, f_ab, f_bb) dense (ia|f|jb) tensors as flat (nov_a, nov_a),
    (nov_a, nov_b), (nov_b, nov_b) matrices on ao's device (JAX
    `response/fxc_tensor.py:87`).  orbs_*: (occupied, virtual) coefficient
    tensors; ``same``: the two spins share their orbitals (a closed-shell
    or restricted-open reference with the same split), so one set of
    features serves both.  Per chunk, the sum over points and components
    is one product G^T F with G_d = sum_c F_c H_cd."""
    H = weighted_hessian(spec, weights, rho0)
    mgga = len(rho0) == 6
    nf = 5 if mgga else 4
    nova = orbs_a[0].shape[1] * orbs_a[1].shape[1]
    novb = orbs_b[0].shape[1] * orbs_b[1].shape[1]
    kw = dict(dtype=ao.dtype, device=ao.device)
    faa = torch.zeros((nova, nova), **kw)
    fab = torch.zeros((nova, novb), **kw)
    fbb = torch.zeros((novb, novb), **kw)

    def acc(out, F1, Hc, F2):
        G = torch.einsum("cgp,gcd->dgp", F1, Hc)
        out.addmm_(G.reshape(-1, F1.shape[-1]).T, F2.reshape(-1, F2.shape[-1]))

    for g0 in range(0, ao.shape[1], chunk):
        g = slice(g0, g0 + chunk)
        Fa = mo_pair_features(ao[:, g], *orbs_a, tau=mgga)
        Fb = Fa if same else mo_pair_features(ao[:, g], *orbs_b, tau=mgga)
        Hc = H[g]
        acc(faa, Fa, Hc[:, :nf, :nf], Fa)
        acc(fab, Fa, Hc[:, :nf, nf:], Fb)
        acc(fbb, Fb, Hc[:, nf:, nf:], Fb)
    return faa, fab, fbb
