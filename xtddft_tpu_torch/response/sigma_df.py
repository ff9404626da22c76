"""Density-fitted MO-basis X-TDA sigma operator (the large-Nbf path).

Counterpart of the JAX package's `response/sigma_df.py` for dense B on
R/RO and U references: the spin-conserving `xtda_sigma_df` and the spin-flip
`sf_sigma_df` (up and down) and `xsf_sigma_df` (spin-adapted flip-down).
Every sigma build is a handful of contractions over the fitted MO tensor

    B[P, p, q]  (metric^{-1/2}-dressed),

    J:  t_P   = B[P,ov] . z          ;  v += B[ov,P] . t_P
    K:  T[P,o,v'] = B_vv[P,v',v] z_ov;  v -= B_oo[P,o,o'] T[P,o,v']

plus the fxc response factored through MO values on the grid (the flip
channels have no J; their xc kernel is a per-point factor between the two
grid contractions).  A range-separated hybrid adds a second exchange pass
on the erf-attenuated tensor ``B_lr`` scaled by ``hyb_lr``; a meta-GGA adds
the transition kinetic-energy density (K2's tau row) and its back-projection
(K3's tau term).  The
exchange (`kernels/df_exchange.py`) and the two grid contractions of the
fxc (`kernels/grid_rho1.py`, `kernels/grid_back.py`) are hand-written CUDA
kernels on the card and their plain torch versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from xtddft_tpu_torch.kernels.df_exchange import df_exchange, rpa_aligned, rpa_exchange
from xtddft_tpu_torch.kernels.grid_back import grid_back
from xtddft_tpu_torch.kernels.grid_rho1 import MAX_POINTS as K2_MAX_POINTS
from xtddft_tpu_torch.kernels.grid_rho1 import grid_rho1
from xtddft_tpu_torch.response.reference_state import Reference
from xtddft_tpu_torch.response.sigma import SigmaOperator, _rho0
from xtddft_tpu_torch.xc import interface as xci
from xtddft_tpu_torch.xc import registry as xc_registry
from xtddft_tpu_torch.xc.registry import XCSpec

# grid points per chunk: the unit of the jvp grouping and of the grid's
# padding (K2 and K3 launch once per jvp group)
GRID_CHUNK = 4096
JVP_POINTS = 1 << 20  # (trial vectors x grid points) per fxc jvp call
# (vectors x components x points) of rho1 per spin-flip grid span: 256 MiB of
# r in f64 and as much of wv.  One span holds the whole grid up to 178 vectors
# at 187,644 points with one component (44 with four), 682 (170) at 49,152.
SF_SPAN_ELEMS = 1 << 25


@dataclasses.dataclass
class DFData:
    """Everything the DF sigma path needs, on the device.

    B: (naux, nmo, nmo) fitted MO integrals, metric-dressed so that
       (pq|rs) ~= sum_P B[P,p,q] B[P,r,s].
    phi: (4, ngrid, nmo) MO values+gradients on the DFT grid (None for
       hybrid-only references).
    rho0: (ra, rb, ga, gb), and (ta, tb) after them for a meta-GGA.
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
    (weight 0, density 1, and tau 1 for a meta-GGA: with a zero gradient it
    gives z = 0): real-molecule grids reach rho ~ 1e-30 where GGA fxc
    derivatives overflow in f32 (the f64 MASK_RHO=1e-11 floor is not
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
        ra, rb, ga, gb, *taus = (r.to(torch.float64) for r in data.rho0)
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
        ) + tuple(torch.where(mask, t, one).to(dtype) for t in taus)
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
    sequence of arrays, the meta-GGA 6-tuple included; ints and floats as
    scalars), e.g. a JAX-built DFData carried across as numpy: every field
    of DFData (B_lr, hyb_lr, the beta tensors) is carried.  ``spec_name``
    resolves the XC spec."""
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


def _refuse_unported(data: DFData, spmd: bool, packed_row: str) -> None:
    """Options of the JAX sigmas that the port does not carry yet raise,
    naming their ROADMAP item."""
    if spmd:
        raise NotImplementedError(
            "spmd sigma: multi-GPU is not ported yet (ROADMAP queue 1, item 15)")
    if data.packed:
        raise NotImplementedError(
            f"packed B: not ported yet (ROADMAP queue 1, item 9; queue 2 row {packed_row})")
    if data.B.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sigma: B in f32 or f64 only, got {data.B.dtype}")


def xtda_sigma_df(data: DFData, spin_adapt: bool = True, spmd: bool = False,
                  with_b: bool = False) -> SigmaOperator:
    """Spin-conserving (U/X-)TDA sigma over DF tensors.

    Same natural layout and dA math as the JAX `xtda_sigma_df` (alpha
    (nocca x nvira) rows then beta (noccb x nvirb)): J and K from B (and a
    range-separated hybrid's long-range K from B_lr, one exchange-only K1
    pass per spin, JAX `:580-588`), the Fock terms, the spin-adaptation dA
    terms, and fxc through the MO-grid factorization in grid chunks of 4096
    points (zero-weight padded; a meta-GGA's tau row and term included).
    matvec takes and returns (nz, dim) tensors on B's device in B's dtype.

    with_b: the paired operator of TDHF/RPA (JAX `:594-603`, `:637-644`):
    matvec returns the stacked (2, nz, dim) [A z, B z], where B z is the
    Coulomb back-projection and fxc term of A z, minus hyb times K1's RPA
    exchange on B (and hyb_lr times that on B_lr), with no Fock and no dA
    term.  The A half is the ``with_b=False`` matvec, launch for launch;
    the RPA launches follow it, on aligned copies of each spin's ov block
    (and of B_lr's) made here once (`df_exchange.rpa_aligned`), whose
    seconds the operator's ``setup_s["rpa_aligned_s"]`` holds."""
    _refuse_unported(data, spmd, packed_row="7")
    nc, no, nv = data.nc, data.no, data.nv
    nmo = data.nmo
    nocca, nvira = nc + no, nv
    noccb, nvirb = nc, no + nv
    B = data.B
    Bb = data.B_b if data.B_b is not None else B
    dev, dt = B.device, B.dtype
    hyb = data.hyb
    naux = B.shape[0]
    has_lr = data.B_lr is not None and data.hyb_lr != 0.0
    if has_lr:
        B_lr = data.B_lr
        Bb_lr = data.B_lr_b if data.B_lr_b is not None else B_lr

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
        ra_s, rb_s, ga_s, gb_s, *tau_s = rho_s
        # a meta-GGA's (ta, tb) padded with the benign tau = 1 (JAX :372-377)
        rho_p = (_padded(ra_s, 1.0), _padded(rb_s, 1.0), _padded(ga_s), _padded(gb_s)) \
            + tuple(_padded(t, 1.0) for t in tau_s)
        mgga = bool(tau_s)
        ncomp = 5 if mgga else 4
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
    setup_s = {}
    if with_b:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        ra, rb = rpa_aligned(B, 0, nocca, nocca, nvira), rpa_aligned(Bb, 0, noccb, noccb, nvirb)
        if has_lr:
            ra_lr = rpa_aligned(B_lr, 0, nocca, nocca, nvira)
            rb_lr = rpa_aligned(Bb_lr, 0, noccb, noccb, nvirb)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        setup_s["rpa_aligned_s"] = time.perf_counter() - t0

    def _fxc(za, zb):
        """Grid-chunked fxc response: rho1 (K2), the functional jvp per
        trial vector, back-projection to (o, v) (K3).  The jvp is
        pointwise, so it runs over a group of chunks at once: each
        torch.func call dispatches hundreds of small operations, whatever
        the number of points it covers.  K2 and K3 take the group's whole
        point span in one launch per spin (a meta-GGA: K2 with its tau row,
        K3 with its tau term)."""
        nz = za.shape[0]
        fxa = torch.zeros((nz, nocca, nvira), dtype=dt, device=dev)
        fxb = torch.zeros((nz, noccb, nvirb), dtype=dt, device=dev)
        group = max(1, JVP_POINTS // (nz * gc))
        for c0 in range(0, ngc, group):
            span = slice(c0 * gc, min(ngc, c0 + group) * gc)
            r1a = grid_rho1(phi_a[:, span], za, 0, nocca, mask_p[span], ncomp=ncomp)
            r1b = grid_rho1(phi_b[:, span], zb, 0, noccb, mask_p[span], ncomp=ncomp)
            w_g = w_p[span]
            rho_g = tuple(r[..., span] for r in rho_p)
            drho = (r1a[:, 0], r1b[:, 0], r1a[:, 1:4], r1b[:, 1:4])
            if mgga:
                drho = drho + (r1a[:, 4], r1b[:, 4])
            dv = torch.func.vmap(lambda d: respond(w_g, rho_g, d))(drho)
            grid_back(dv[0], dv[2], phi_a[:, span], 0, nocca, fxa,
                      dwt=dv[4] if mgga else None)
            grid_back(dv[1], dv[3], phi_b[:, span], 0, noccb, fxb,
                      dwt=dv[5] if mgga else None)
        return fxa, fxb

    def matvec(zs):
        zs = torch.as_tensor(zs, dtype=dt, device=dev)
        nz = zs.shape[0]
        za = zs[:, :na].reshape(nz, nocca, nvira)
        zb = zs[:, na:].reshape(nz, noccb, nvirb)
        ta, Ka = df_exchange(B, za, 0, nocca)
        tb, Kb = df_exchange(Bb, zb, 0, noccb)
        t = ta + tb
        ja = (t @ bov_a).reshape(nz, nocca, nvira)
        jb = (t @ bov_b).reshape(nz, noccb, nvirb)
        v1a = ja - hyb * Ka
        v1b = jb - hyb * Kb
        if has_lr:
            # the RSH long-range exchange, (alpha - hyb) K over B_lr
            v1a = v1a - data.hyb_lr * df_exchange(B_lr, za, 0, nocca, with_t=False)[1]
            v1b = v1b - data.hyb_lr * df_exchange(Bb_lr, zb, 0, noccb, with_t=False)[1]
        fxa = fxb = None
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
        az = torch.cat([v1a.reshape(nz, -1), v1b.reshape(nz, -1)], dim=1)
        if not with_b:
            return az
        return torch.stack([az, _b_half(za, zb, ja, jb, fxa, fxb)])

    def _b_half(za, zb, ja, jb, fxa, fxb):
        """B z from A's Coulomb (ja, jb) and fxc (fxa, fxb) terms: the RPA
        exchange (ib|ja) z_jb in place of K, no Fock and no dA term."""
        b1a = ja - hyb * rpa_exchange(B, za, 0, nocca, aligned=ra)
        b1b = jb - hyb * rpa_exchange(Bb, zb, 0, noccb, aligned=rb)
        if has_lr:
            b1a = b1a - data.hyb_lr * rpa_exchange(B_lr, za, 0, nocca, aligned=ra_lr)
            b1b = b1b - data.hyb_lr * rpa_exchange(Bb_lr, zb, 0, noccb, aligned=rb_lr)
        if fxa is not None:
            b1a = b1a + fxa
            b1b = b1b + fxb
        nz = za.shape[0]
        return torch.cat([b1a.reshape(nz, -1), b1b.reshape(nz, -1)], dim=1)

    ea = np.diag(data.fock_mo[0])
    eb = np.diag(data.fock_mo[1])
    hdiag = np.concatenate([
        (ea[nocca:][None, :] - ea[:nocca][:, None]).ravel(),
        (eb[noccb:][None, :] - eb[:noccb][:, None]).ravel(),
    ])

    def to_blocked(v):
        rest = v.shape[1:]  # explicit: a closed shell's CO block is empty
        top = v[:na]
        beta = v[na:].reshape(noccb, nvirb, *rest)
        co = beta[:, :no].reshape(noccb * no, *rest)
        cv = beta[:, no:].reshape(noccb * nv, *rest)
        return np.concatenate([top, co, cv], axis=0)

    return SigmaOperator(matvec=matvec, hdiag=hdiag, dim=dim, _to_blocked=to_blocked,
                         device=dev, dtype=dt, setup_s=setup_s)


def _flip_block(data: DFData, extype: str, method: int):
    """The part every spin-flip sigma shares, on the rectangular (n_o, n_v)
    block of one flip direction:

        apply(z)[x,i,a] = -hyb sum_P Bocc[P,i,j] Bvir[P,a,b] z[x,j,b]     (K1)
                          (- hyb_lr, the same over B_lr: an RSH's long range)
                          + back(sf_k . rho1(z))                      (K2, K3)
                          + f_vir z - z f_occ,

    flip-up: (occ, vir) = (beta-occupied [0, nc), alpha-virtual [nc+no,
    nmo)); flip-down: (alpha-occupied [0, nc+no), beta-virtual [nc, nmo)),
    whose ranges overlap on the open shells.  There is no Coulomb term.  The
    SF kernel ``sf_k`` carries the quadrature weight and is zero on
    negligible-density points, so the transition density goes unmasked.  A
    meta-GGA's multicollinear kernel is (g, 5, 5): K2 gives the tau row and
    K3 takes the tau term (JAX `:1019`, `:1121-1133`).
    Returns (apply, n_o, n_v, e_occ, e_vir)."""
    nc, no, nv = data.nc, data.no, data.nv
    B_a, phi_a = data.B, data.phi
    B_b = data.B_b if data.B_b is not None else B_a
    phi_b = data.phi_b if data.phi_b is not None else phi_a
    if extype == "up":
        n_o, o_s, n_v, v0, v_s = nc, 1, nv, nc + no, 0
    elif extype == "down":
        n_o, o_s, n_v, v0, v_s = nc + no, 0, no + nv, nc, 1
    else:
        raise ValueError(f"extype must be 'up' or 'down', got {extype!r}")
    B_o, B_v = (B_a, B_b)[o_s], (B_a, B_b)[v_s]
    phi_o, phi_v = (phi_a, phi_b)[o_s], (phi_a, phi_b)[v_s]
    dev, dt = B_a.device, B_a.dtype
    hyb = data.hyb
    has_lr = data.B_lr is not None and data.hyb_lr != 0.0
    if has_lr:
        lr = (data.B_lr, data.B_lr_b if data.B_lr_b is not None else data.B_lr)
        Blr_o, Blr_v = lr[o_s], lr[v_s]
    f_occ_np = np.asarray(data.fock_mo[o_s])[:n_o, :n_o]
    f_vir_np = np.asarray(data.fock_mo[v_s])[v0:, v0:]
    f_occ = torch.as_tensor(f_occ_np, dtype=dt, device=dev)
    f_vir = torch.as_tensor(f_vir_np, dtype=dt, device=dev)

    has_xc = (method in (0, 1) and data.spec is not None
              and bool(data.spec.components) and data.phi is not None)
    if has_xc:
        if method == 0:
            sf_k = xci.sf_kernel_alda0(data.spec, data.grid_w, data.rho0).to(dt)  # (g,)
            kdim = 1
        else:
            from xtddft_tpu_torch.xc.mcol import sf_kernel_mcol

            sf_k = sf_kernel_mcol(data.spec, data.grid_w, data.rho0).to(dt)  # (g, 4|5, 4|5)
            kdim = int(sf_k.shape[-1])
        ngrid = int(sf_k.shape[0])

    def _sf_xc(z):
        """One launch of K2 and of K3 per point span, the per-point kernel
        application between them as a torch op."""
        nz = z.shape[0]
        out = torch.zeros((nz, n_o, n_v), dtype=dt, device=dev)
        span = max(1, min(ngrid, K2_MAX_POINTS, SF_SPAN_ELEMS // (nz * kdim)))
        for g0 in range(0, ngrid, span):
            g = slice(g0, g0 + span)
            po, pv = phi_o[:, g], phi_v[:, g]
            r = grid_rho1(po, z, 0, v0, None, phi_v=pv, ncomp=kdim)
            if kdim == 1:
                grid_back(sf_k[None, g] * r[:, 0], None, po, 0, v0, out, phi_v=pv)
            else:
                wv = torch.einsum("gab,xbg->xag", sf_k[g], r)
                grid_back(wv[:, 0], wv[:, 1:4], po, 0, v0, out, phi_v=pv,
                          dwt=wv[:, 4] if kdim == 5 else None)
        return out

    def apply(z):
        if z.shape[0] == 0 or n_o == 0 or n_v == 0:
            return torch.zeros_like(z)
        vs = z @ f_vir.T - f_occ @ z
        if hyb != 0.0:
            _, K = df_exchange(B_o, z, 0, v0, B_vir=None if B_v is B_o else B_v,
                               with_t=False)
            vs = vs - hyb * K
        if has_lr:
            _, K = df_exchange(Blr_o, z, 0, v0, B_vir=None if Blr_v is Blr_o else Blr_v,
                               with_t=False)
            vs = vs - data.hyb_lr * K
        if has_xc:
            vs = vs + _sf_xc(z)
        return vs

    return apply, n_o, n_v, np.diag(f_occ_np), np.diag(f_vir_np)


def sf_sigma_df(data: DFData, extype: str = "up", method: int = 0,
                spmd: bool = False) -> SigmaOperator:
    """Density-fitted plain SF-TDA sigma (flip-up and flip-down): exchange-only
    two-electron coupling over the fitted B, the SF xc kernel through the
    MO-grid factorization, and the Fock terms (see `_flip_block`).

    Row-major (n_o, n_v) trial layout, as the JAX `sf_sigma_df`; flip-down's
    ``to_blocked`` converts to the CV|CO|OV|OO convention.
    method: 0 = ALDA0, 1 = multicollinear (LDA/GGA), 2 = collinear (HF
    exchange only).  matvec takes and returns (nz, dim) tensors on B's
    device in B's dtype."""
    _refuse_unported(data, spmd, packed_row="9c")
    nc, no, nv = data.nc, data.no, data.nv
    apply, n_o, n_v, e_occ, e_vir = _flip_block(data, extype, method)
    dev, dt = data.B.device, data.B.dtype

    def matvec(zs):
        zs = torch.as_tensor(zs, dtype=dt, device=dev)
        nz = zs.shape[0]
        return apply(zs.reshape(nz, n_o, n_v)).reshape(nz, -1)

    hdiag = (e_vir[None, :] - e_occ[:, None]).ravel()

    def to_blocked(v):
        z = v.reshape(n_o, n_v, -1)
        cv = z[:nc, no:].reshape(nc * nv, -1)
        co = z[:nc, :no].reshape(nc * no, -1)
        ov = z[nc:, no:].reshape(no * nv, -1)
        oo = z[nc:, :no].reshape(no * no, -1)
        return np.concatenate([cv, co, ov, oo], axis=0)

    return SigmaOperator(matvec=matvec, hdiag=hdiag, dim=n_o * n_v,
                         _to_blocked=to_blocked if extype == "down" else None,
                         device=dev, dtype=dt)


def xsf_sigma_df(data: DFData, SA: int = 3, foo: float = 1.0, fglobal: float = 1.0,
                 method: int = 0, remove: bool = True,
                 spmd: bool = False) -> SigmaOperator:
    """Density-fitted XSF-TDA sigma: the flip-down block of `_flip_block`
    (SF exchange from B, ALDA0 or multicollinear kernel on the grid, Fock
    terms) plus the spin-adapted dA with its small MO tensors built from B
    (`response/xsf_terms.py`).

    Vector layout as the JAX `xsf_sigma_df`: CV|CO|OV|OO blocked, the OO
    block compressed through the Sf=Si projector when ``remove`` (to no^2-1
    columns: none at all for a doublet).  ``SA`` 0-3 selects the dA terms,
    ``foo`` scales the OO couplings and ``fglobal`` the whole dA."""
    from xtddft_tpu_torch.response.spaces import sf_oo_projector
    from xtddft_tpu_torch.response.xsf_terms import (apply_delta_a, delta_a_fock_blocks,
                                                     delta_a_tensors_from_df)

    _refuse_unported(data, spmd, packed_row="9c")
    nc, no, nv = data.nc, data.no, data.nv
    apply, n_o, n_v, e_occ, e_vir = _flip_block(data, "down", method)
    dev, dt = data.B.device, data.B.dtype
    d1, d2, d3 = nc * nv, nc * nv + nc * no, nc * nv + nc * no + no * nv
    noo = no * no - 1 if remove else no * no
    dim = d3 + noo
    Vp = sf_oo_projector(no) if remove else None  # (no^2, no^2 - 1), host
    vects = torch.as_tensor(Vp, dtype=dt, device=dev) if remove else None
    dA_on = SA > 0 and data.fock_hf_mo is not None and no > 0
    if dA_on:
        si = 0.5 * no
        dA = delta_a_tensors_from_df(data.B, nc, no, SA)
        dA.update(delta_a_fock_blocks(data.fock_hf_mo[0], data.fock_hf_mo[1], nc, no, dt, dev))

    def matvec(zs):
        zs = torch.as_tensor(zs, dtype=dt, device=dev)
        nz = zs.shape[0]
        zcv = zs[:, :d1].reshape(nz, nc, nv)
        zco = zs[:, d1:d2].reshape(nz, nc, no)
        zov = zs[:, d2:d3].reshape(nz, no, nv)
        zoo = (zs[:, d3:] @ vects.T if remove else zs[:, d3:]).reshape(nz, no, no)
        z = torch.empty((nz, n_o, n_v), dtype=dt, device=dev)
        z[:, :nc, no:] = zcv
        z[:, :nc, :no] = zco
        z[:, nc:, no:] = zov
        z[:, nc:, :no] = zoo
        vs = apply(z)
        if dA_on:
            dcv, dco, dov, doo = apply_delta_a(dA, si, SA, foo, zcv, zco, zov, zoo)
            vs[:, :nc, no:] += fglobal * dcv
            vs[:, :nc, :no] += fglobal * dco
            vs[:, nc:, no:] += fglobal * dov
            vs[:, nc:, :no] += fglobal * doo
        ooo = vs[:, nc:, :no].reshape(nz, -1)
        if remove:
            ooo = ooo @ vects
        return torch.cat([vs[:, :nc, no:].reshape(nz, -1), vs[:, :nc, :no].reshape(nz, -1),
                          vs[:, nc:, no:].reshape(nz, -1), ooo], dim=1)

    e_full = e_vir[None, :] - e_occ[:, None]
    h_oo = e_full[nc:, :no].ravel()
    if remove:
        h_oo = np.einsum("pq,p,pq->q", Vp, h_oo, Vp)
    hdiag = np.concatenate([e_full[:nc, no:].ravel(), e_full[:nc, :no].ravel(),
                            e_full[nc:, no:].ravel(), h_oo])

    def expand(v):
        if not remove:
            return v
        return np.concatenate([v[:d3], Vp @ v[d3:]], axis=0)

    return SigmaOperator(matvec=matvec, hdiag=hdiag, dim=dim, _to_blocked=expand,
                         device=dev, dtype=dt)
