"""Dense fxc (ia|f|jb) tensors from pointwise Hessians of the energy density.

Counterpart of the JAX package's `response/fxc_tensor.py`: the weighted
Hessian of the energy density in the pointwise variables (ra, grad ra, rb,
grad rb) is contracted against occupied-virtual pair features, which is
exact for LDA and GGA alike.  The Hessian comes from ``torch.func`` (the
points are independent, so column b of the summed energy's Hessian is one
jvp of its gradient along direction b on every point at once, the eight
columns one ``vmap`` over the directions); each block
is then one matrix product per chunk of 4096 points over the chunk's pair
features (4, gc, no*nv), which are never formed for the whole grid (benzene
cc-pVDZ: 256 MB a chunk in f64, 18.4 GB for its 294,480 points).  Meta-GGA
(the tau column) raises, as everywhere in the port.
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
    """w * d^2 e / dx^2 per grid point, x = (ra, gax, gay, gaz, rb, gbx,
    gby, gbz): (ng, 8, 8) (JAX `response/fxc_tensor.py:22`)."""
    efn = exc_density_fn(spec)
    ra, rb, ga, gb = rho0[:4]
    dt, dev = ra.dtype, ra.device
    mask = (ra > MASK_RHO) | (rb > MASK_RHO)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)
    w = torch.where(mask, weights, zero)
    # a benign nonzero gradient on dummy points keeps the second derivatives
    # of sqrt(gamma) terms finite
    small = torch.full((), 1e-3, dtype=dt, device=dev)
    X = torch.cat([torch.where(mask, ra, one)[None], torch.where(mask[None], ga, small),
                   torch.where(mask, rb, one)[None], torch.where(mask[None], gb, small)])

    def total(x):
        return torch.sum(efn(x[0], x[4], x[1:4], x[5:8]))

    grad = torch.func.grad(total)
    ng = X.shape[1]
    H = torch.empty((ng, 8, 8), dtype=dt, device=dev)
    for g0 in range(0, ng, HESSIAN_POINTS):
        x = X[:, g0:g0 + HESSIAN_POINTS]
        # the eight unit directions as one batch of tangents: the primal pass
        # runs once, not once per column
        tangents = torch.eye(8, dtype=dt, device=dev)[:, :, None].expand(8, 8, x.shape[1])
        cols = torch.func.vmap(lambda t: torch.func.jvp(grad, (x,), (t,))[1])(tangents)
        H[g0:g0 + HESSIAN_POINTS] = cols.permute(2, 1, 0)
    return H * w[:, None, None]


def mo_pair_features(ao_c, orb_o, orb_v) -> torch.Tensor:
    """(4, gc, no*nv): [phi_i phi_a, grad(phi_i phi_a)] of the (i, a) pairs
    on a chunk of points, ao_c (4, gc, nao); the JAX `pair_features`
    (`response/fxc_tensor.py:67`) with the component axis first.  The
    builders form them a chunk at a time."""
    po = ao_c @ orb_o  # (4, gc, no)
    pv = ao_c @ orb_v
    gc = ao_c.shape[1]
    val = po[0][:, :, None] * pv[0][:, None, :]
    grad = po[1:4][:, :, :, None] * pv[0][None, :, None, :] \
        + po[0][None, :, :, None] * pv[1:4][:, :, None, :]
    return torch.cat([val[None], grad], dim=0).reshape(4, gc, -1)


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
        Fa = mo_pair_features(ao[:, g], *orbs_a)
        Fb = Fa if same else mo_pair_features(ao[:, g], *orbs_b)
        Hc = H[g]
        acc(faa, Fa, Hc[:, 0:4, 0:4], Fa)
        acc(fab, Fa, Hc[:, 0:4, 4:8], Fb)
        acc(fbb, Fb, Hc[:, 4:8, 4:8], Fb)
    return faa, fab, fbb
