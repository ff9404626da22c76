"""Density-fitted MO-basis X-TDA sigma operator (the large-Nbf path).

Counterpart of the JAX package's `response/sigma_df.py` for dense B on
R/RO and U references.  Every sigma build is a handful of contractions over
the fitted MO tensor

    B[P, p, q]  (metric^{-1/2}-dressed),

    J:  t_P   = B[P,ov] . z          ;  v += B[ov,P] . t_P
    K:  T[P,o,v'] = B_vv[P,v',v] z_ov;  v -= B_oo[P,o,o'] T[P,o,v']

plus the fxc response factored through MO values on the grid.  The
exchange (`kernels/df_exchange.py`) and the two grid contractions of the
fxc (`kernels/grid_rho1.py`, `kernels/grid_back.py`) are hand-written CUDA
kernels on the card and their plain torch versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from xtddft_tpu_torch.kernels.df_exchange import df_exchange
from xtddft_tpu_torch.kernels.grid_back import grid_back
from xtddft_tpu_torch.kernels.grid_rho1 import grid_rho1
from xtddft_tpu_torch.response.reference_state import Reference
from xtddft_tpu_torch.response.sigma import SigmaOperator, _rho0
from xtddft_tpu_torch.xc import interface as xci
from xtddft_tpu_torch.xc import registry as xc_registry
from xtddft_tpu_torch.xc.registry import XCSpec

AUX_BUDGET = 1.5e8  # elements of the plain exchange's T intermediate per chunk
GRID_CHUNK = 4096  # grid points per K2/K3 launch
JVP_POINTS = 1 << 20  # (trial vectors x grid points) per fxc jvp call


@dataclasses.dataclass
class DFData:
    """Everything the DF sigma path needs, on the device.

    B: (naux, nmo, nmo) fitted MO integrals, metric-dressed so that
       (pq|rs) ~= sum_P B[P,p,q] B[P,r,s].
    phi: (4, ngrid, nmo) MO values+gradients on the DFT grid (None for
       hybrid-only references).
    """

    nc: int
    no: int
    nv: int
    B: torch.Tensor
    fock_mo: np.ndarray  # (2, nmo, nmo) alpha/beta MO Fock, host
    hyb: float
    spec: XCSpec | None = None
    phi: torch.Tensor | None = None
    grid_w: torch.Tensor | None = None
    rho0: tuple | None = None
    fock_hf_mo: np.ndarray | None = None  # (2, nmo, nmo) for dA
    # RSH: long-range fitted MO tensor and its K coefficient (alpha - hyb)
    B_lr: torch.Tensor | None = None
    hyb_lr: float = 0.0
    # unrestricted references: beta-MO transforms (None: beta = alpha)
    B_b: torch.Tensor | None = None
    B_lr_b: torch.Tensor | None = None
    phi_b: torch.Tensor | None = None
    packed: bool = False

    @property
    def nmo(self):
        return self.fock_mo.shape[-1]


def _aux_chunk(naux, nz, nocc, nvir, budget=AUX_BUDGET):
    """Largest divisor of naux keeping the plain exchange's T intermediate
    (nz*chunk*nocc*nvir elements) under budget."""
    target = int(max(1, budget // max(1, nz * nocc * nvir)))
    for c in range(min(target, naux), 0, -1):
        if naux % c == 0:
            return c
    return 1


def _mo_transform(B_ao: torch.Tensor, mo: torch.Tensor) -> torch.Tensor:
    """(naux, nao, nao) -> (naux, nmo, nmo), 64 aux rows at a time."""
    out = torch.empty((B_ao.shape[0], mo.shape[1], mo.shape[1]),
                      dtype=B_ao.dtype, device=B_ao.device)
    for p0 in range(0, B_ao.shape[0], 64):
        out[p0:p0 + 64] = mo.T @ B_ao[p0:p0 + 64] @ mo
    return out


def build_df_data(ref: Reference) -> DFData:
    """Real-molecule DF data from a Reference (AutoAux fit), on the Env's
    device and dtype."""
    env = ref.env
    mo = env.tensor(ref.mo_a)
    unrestricted = ref.mo_b is not ref.mo_a and not np.array_equal(
        ref.mo_a, ref.mo_b)
    mo_b = env.tensor(ref.mo_b) if unrestricted else None
    B = _mo_transform(env.df_B(0.0), mo)
    B_b = _mo_transform(env.df_B(0.0), mo_b) if unrestricted else None
    B_lr = B_lr_b = None
    hyb_lr = 0.0
    if ref.omega != 0.0 and abs(ref.alpha - ref.hyb) > 1e-12:
        B_lr = _mo_transform(env.df_B(ref.omega), mo)
        if unrestricted:
            B_lr_b = _mo_transform(env.df_B(ref.omega), mo_b)
        hyb_lr = ref.alpha - ref.hyb
    phi = phi_b = grid_w = rho0 = None
    if ref.spec is not None and ref.spec.components:
        phi = env.ao @ mo
        if unrestricted:
            phi_b = env.ao @ mo_b
        grid_w = env.grid_weights
        rho0 = _rho0(ref)
    fock_mo = np.stack([ref.fock_a_mo, ref.fock_b_mo])
    fock_hf = (
        np.stack([ref.fock_a_hf_mo, ref.fock_b_hf_mo])
        if ref.fock_a_hf_mo is not None
        else None
    )
    return DFData(
        nc=ref.nc, no=ref.no, nv=ref.nv, B=B, fock_mo=fock_mo,
        hyb=ref.hyb, spec=ref.spec, phi=phi, grid_w=grid_w, rho0=rho0,
        fock_hf_mo=fock_hf, B_lr=B_lr, hyb_lr=hyb_lr,
        B_b=B_b, B_lr_b=B_lr_b, phi_b=phi_b,
    )


def cast_df_data(data: DFData, dtype=torch.float32,
                 rho_floor: float = 3e-7) -> DFData:
    """Precision-cast DFData: every tensor and the Fock matrices in ``dtype``.

    Grid points whose density falls below ``rho_floor`` are neutralized
    (weight 0, density 1): real-molecule grids reach rho ~ 1e-30 where GGA
    fxc derivatives overflow in f32 (the f64 MASK_RHO=1e-11 floor is not
    low-precision-safe); their true contribution is negligible."""
    np_dt = np.float32 if dtype == torch.float32 else np.float64
    kw = {
        "B": data.B.to(dtype),
        "fock_mo": np.asarray(data.fock_mo, dtype=np_dt),
    }
    for name in ("B_lr", "B_b", "B_lr_b", "phi_b"):
        if getattr(data, name) is not None:
            kw[name] = getattr(data, name).to(dtype)
    if data.fock_hf_mo is not None:
        kw["fock_hf_mo"] = np.asarray(data.fock_hf_mo, dtype=np_dt)
    if data.phi is not None:
        ra, rb, ga, gb = (r.to(torch.float64) for r in data.rho0)
        w = data.grid_w.to(torch.float64)
        mask = (ra > rho_floor) | (rb > rho_floor)
        zero = torch.zeros((), dtype=torch.float64, device=w.device)
        one = torch.ones((), dtype=torch.float64, device=w.device)
        kw["phi"] = data.phi.to(dtype)
        kw["grid_w"] = torch.where(mask, w, zero).to(dtype)
        kw["rho0"] = (
            torch.where(mask, ra, one).to(dtype),
            torch.where(mask, rb, one).to(dtype),
            torch.where(mask[None, :], ga, zero).to(dtype),
            torch.where(mask[None, :], gb, zero).to(dtype),
        )
    return dataclasses.replace(data, **kw)


def synthetic_df_data(nmo=1000, nc=78, no=2, naux=2000, ngrid=49152,
                      xc: str = "bhandhlyp", generator: torch.Generator | None = None,
                      device=None, dtype=torch.float32) -> DFData:
    """Random but well-formed DF data (the bench's operator shape), made on
    ``device`` from ``generator`` (a torch.Generator on that device)."""
    from xtddft_tpu_torch import config

    device, _ = config.resolve(device, dtype)
    g = generator if generator is not None else torch.Generator(device).manual_seed(0)
    nv = nmo - nc - no

    def normal(*shape, dt=dtype):
        return torch.randn(shape, generator=g, device=device, dtype=dt)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=device, dtype=dtype)

    # symmetric by construction, B_P = G_P G_P^T, built per aux slice so the
    # only full-size buffer is B itself
    k_rank = 8
    B = torch.empty((naux, nmo, nmo), dtype=dtype, device=device)
    scale = 1.0 / math.sqrt(naux * nmo * k_rank)
    for p0 in range(0, naux, 256):
        G = normal(min(256, naux - p0), nmo, k_rank, dt=torch.float32)
        B[p0:p0 + G.shape[0]] = (torch.bmm(G, G.transpose(1, 2)) * scale).to(dtype)
    spec = xc_registry.resolve(xc)

    def host_normal(*shape):
        return normal(*shape, dt=torch.float64).cpu().numpy()

    e = np.sort(uniform(-20.0, 5.0, nmo).to(torch.float64).cpu().numpy())
    fa = np.diag(e) + 1e-3 * host_normal(nmo, nmo)
    fa = 0.5 * (fa + fa.T)
    fb = fa + 1e-3 * host_normal(nmo, nmo)
    fb = 0.5 * (fb + fb.T)
    fhfa = fa + 1e-3 * host_normal(nmo, nmo)
    fhfa = 0.5 * (fhfa + fhfa.T)
    fhfb = fb + 1e-3 * host_normal(nmo, nmo)
    fhfb = 0.5 * (fhfb + fhfb.T)
    phi = normal(4, ngrid, nmo) / math.sqrt(nmo)
    w = uniform(0.01, 1.0, ngrid)
    ra = uniform(0.05, 1.0, ngrid)
    rb = ra * uniform(0.5, 1.0, ngrid)
    ga = 0.1 * normal(3, ngrid)
    gb = 0.1 * normal(3, ngrid)
    return DFData(
        nc=nc, no=no, nv=nv, B=B, fock_mo=np.stack([fa, fb]), hyb=spec.hyb,
        spec=spec, phi=phi, grid_w=w, rho0=(ra, rb, ga, gb),
        fock_hf_mo=np.stack([fhfa, fhfb]),
    )


def df_data_from_arrays(fields: dict, spec_name: str | None, device=None,
                        dtype=torch.float64) -> DFData:
    """DFData from host arrays keyed by DFData field name (``rho0`` as a
    sequence of arrays; ints and floats as scalars), e.g. a JAX-built
    DFData carried across as numpy.  ``spec_name`` resolves the XC spec."""
    from xtddft_tpu_torch import config

    device, dtype = config.resolve(device, dtype)

    def dev(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    kw = {}
    for f in dataclasses.fields(DFData):
        if f.name not in fields or fields[f.name] is None or f.name == "spec":
            continue
        val = fields[f.name]
        if f.name in ("nc", "no", "nv"):
            kw[f.name] = int(val)
        elif f.name in ("hyb", "hyb_lr"):
            kw[f.name] = float(val)
        elif f.name == "packed":
            kw[f.name] = bool(val)
        elif f.name in ("fock_mo", "fock_hf_mo"):
            kw[f.name] = np.asarray(val, dtype=np.float64)
        elif f.name == "rho0":
            kw[f.name] = tuple(dev(r) for r in val)
        else:
            kw[f.name] = dev(val)
    kw["spec"] = xc_registry.resolve(spec_name) if spec_name else None
    return DFData(**kw)


def xtda_sigma_df(data: DFData, spin_adapt: bool = True, spmd: bool = False,
                  with_b: bool = False) -> SigmaOperator:
    """Spin-conserving (U/X-)TDA sigma over DF tensors.

    Same natural layout and dA math as the JAX `xtda_sigma_df` (alpha
    (nocca x nvira) rows then beta (noccb x nvirb)): J and K from B, the
    Fock terms, the spin-adaptation dA terms, and fxc through the MO-grid
    factorization in grid chunks of 4096 points (zero-weight padded).
    matvec takes and returns (nz, dim) tensors on B's device in B's dtype."""
    if spmd:
        raise NotImplementedError(
            "spmd sigma: multi-GPU is not ported yet (ROADMAP queue 1, item 15)")
    if with_b:
        raise NotImplementedError(
            "with_b (RPA B matvec): not ported yet (ROADMAP queue 1, item 10)")
    if data.packed:
        raise NotImplementedError(
            "packed B: not ported yet (ROADMAP queue 1, item 9; queue 2 row 7)")
    if data.B_lr is not None and data.hyb_lr != 0.0:
        raise NotImplementedError(
            "RSH long-range exchange (B_lr): not ported yet (ROADMAP queue 1, item 2)")
    nc, no, nv = data.nc, data.no, data.nv
    nmo = data.nmo
    nocca, nvira = nc + no, nv
    noccb, nvirb = nc, no + nv
    B = data.B
    Bb = data.B_b if data.B_b is not None else B
    dev, dt = B.device, B.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"xtda_sigma_df: B in f32 or f64 only, got {dt}")
    hyb = data.hyb
    naux = B.shape[0]

    def tens(a):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    fa = tens(data.fock_mo[0])
    fb = tens(data.fock_mo[1])
    fa_vv, fa_oo = fa[nocca:, nocca:], fa[:nocca, :nocca]
    fb_vv, fb_oo = fb[noccb:, noccb:], fb[:noccb, :noccb]
    # Coulomb back-projection blocks, made contiguous once per operator
    bov_a = B[:, :nocca, nocca:].reshape(naux, -1)
    bov_b = Bb[:, :noccb, noccb:].reshape(naux, -1)

    has_xc = data.spec is not None and bool(data.spec.components) and data.phi is not None
    if has_xc:
        respond = xci.make_fxc_jvp(data.spec)
        w_s, rho_s, mask = xci._sanitize(data.grid_w, data.rho0)
        ngrid = int(w_s.shape[0])
        gc = min(GRID_CHUNK, ngrid)
        ngc = -(-ngrid // gc)
        pad = ngc * gc - ngrid

        def _padded(a, fill=0.0, axis=-1):
            """Append ``pad`` points of value ``fill`` to the grid axis."""
            if not pad:
                return a
            shape = list(a.shape)
            shape[axis] = pad
            return torch.cat([a, torch.full(shape, fill, dtype=a.dtype, device=a.device)], axis)

        phi_a = _padded(data.phi, axis=1)
        phi_b = _padded(data.phi_b, axis=1) if data.phi_b is not None else phi_a
        w_p = _padded(w_s)
        ra_s, rb_s, ga_s, gb_s = rho_s
        rho_p = (_padded(ra_s, 1.0), _padded(rb_s, 1.0), _padded(ga_s), _padded(gb_s))
        mask_p = _padded(mask.to(dt))

    dA = spin_adapt and data.fock_hf_mo is not None and no > 0
    if dA:
        si = 0.5 * no
        dF = data.fock_hf_mo[1] - data.fock_hf_mo[0]
        dFV = tens(dF[nc + no:, nc + no:])
        dFC = tens(dF[:nc, :nc])
        f1 = float(0.5 * (1.0 - np.sqrt((si + 1) / si) + 1.0 / (2 * si)))
        f2 = float(0.5 * (-1.0 + np.sqrt((si + 1) / si) + 1.0 / (2 * si)))
        fx = float(0.5 / (2.0 * si))

    na = nocca * nvira
    dim = na + noccb * nvirb

    def _fxc(za, zb):
        """Grid-chunked fxc response: rho1 on each grid chunk (K2), the
        functional jvp per trial vector, back-projection to (o, v) (K3).
        The jvp is pointwise, so it runs over a group of chunks at once:
        each torch.func call dispatches hundreds of small operations,
        whatever the number of points it covers."""
        nz = za.shape[0]
        fxa = torch.zeros((nz, nocca, nvira), dtype=dt, device=dev)
        fxb = torch.zeros((nz, noccb, nvirb), dtype=dt, device=dev)
        group = max(1, JVP_POINTS // (nz * gc))
        for c0 in range(0, ngc, group):
            chunks = [slice(c * gc, (c + 1) * gc) for c in range(c0, min(ngc, c0 + group))]
            r1a = torch.cat([grid_rho1(phi_a[:, s], za, 0, nocca, mask_p[s])
                             for s in chunks], dim=-1)
            r1b = torch.cat([grid_rho1(phi_b[:, s], zb, 0, noccb, mask_p[s])
                             for s in chunks], dim=-1)
            span = slice(chunks[0].start, chunks[-1].stop)
            w_g = w_p[span]
            rho_g = tuple(r[..., span] for r in rho_p)
            dwva, dwvb, dwga, dwgb = torch.func.vmap(
                lambda d: respond(w_g, rho_g, d))(
                    (r1a[:, 0], r1b[:, 0], r1a[:, 1:4], r1b[:, 1:4]))
            for i, s in enumerate(chunks):
                k = slice(i * gc, (i + 1) * gc)
                grid_back(dwva[:, k], dwga[..., k], phi_a[:, s], 0, nocca, fxa)
                grid_back(dwvb[:, k], dwgb[..., k], phi_b[:, s], 0, noccb, fxb)
        return fxa, fxb

    def matvec(zs):
        zs = torch.as_tensor(zs, dtype=dt, device=dev)
        nz = zs.shape[0]
        za = zs[:, :na].reshape(nz, nocca, nvira)
        zb = zs[:, na:].reshape(nz, noccb, nvirb)
        ta, Ka = df_exchange(B, za, 0, nocca, _aux_chunk(naux, nz, nocca, nvira))
        tb, Kb = df_exchange(Bb, zb, 0, noccb, _aux_chunk(naux, nz, noccb, nvirb))
        t = ta + tb
        v1a = (t @ bov_a).reshape(nz, nocca, nvira) - hyb * Ka
        v1b = (t @ bov_b).reshape(nz, noccb, nvirb) - hyb * Kb
        if has_xc:
            fxa, fxb = _fxc(za, zb)
            v1a = v1a + fxa
            v1b = v1b + fxb
        v1a = v1a + za @ fa_vv.T - fa_oo @ za
        v1b = v1b + zb @ fb_vv.T - fb_oo @ zb
        if dA:
            zac = za[:, :noccb, :]
            zbv = zb[:, :, -nvira:]
            coup_a = f1 * (zac @ dFV.T) + f2 * (dFC @ zac)
            cross_b = fx * (zbv @ dFV.T + dFC @ zbv)
            coup_b = f2 * (zbv @ dFV.T) + f1 * (dFC @ zbv)
            cross_a = fx * (zac @ dFV.T + dFC @ zac)
            v1a[:, :noccb, :] += coup_a - cross_b
            v1b[:, :, -nvira:] += coup_b - cross_a
        return torch.cat([v1a.reshape(nz, -1), v1b.reshape(nz, -1)], dim=1)

    ea = np.diag(data.fock_mo[0])
    eb = np.diag(data.fock_mo[1])
    hdiag = np.concatenate([
        (ea[nocca:][None, :] - ea[:nocca][:, None]).ravel(),
        (eb[noccb:][None, :] - eb[:noccb][:, None]).ravel(),
    ])

    def to_blocked(v):
        top = v[:na]
        beta = v[na:].reshape(noccb, nvirb, -1)
        co = beta[:, :no].reshape(noccb * no, -1)
        cv = beta[:, no:].reshape(noccb * nv, -1)
        return np.concatenate([top, co, cv], axis=0)

    return SigmaOperator(matvec=matvec, hdiag=hdiag, dim=dim, _to_blocked=to_blocked,
                         device=dev, dtype=dt)
