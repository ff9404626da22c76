"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, drive, report.

    python3 chip_smoke.py [--out PATH]

Phases (any failure raises; the script exits non-zero and prints no result):

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   no CUDA device is a failure;
1. build the native integral engine and the CUDA kernels K1-K3 from the
   checkout's sources, all at once, with the seconds each build took;
2. each kernel against its plain torch version at the main path's shapes
   (TTM/STO-3G and the nmo=1000 bench operator; K2 and K3 on one 4096-point
   chunk and on the span of one jvp group, which the sigma passes them in
   one launch), f64 and f32, with median CUDA-event times of both and the
   card's bound for the same work (``response/flops.py``) and, where one
   PyTorch call computes the same function (the exchange-only and value-only
   modes: a single einsum), that call's time as ``library_ms``; K1 also at its
   edge cases (nocc above 256, nvir below one tile, one trial vector); then
   the spin-flip modes (exchange-only K1, value-only and four-component K2
   and K3 on overlapping o/v ranges, one case with the virtual side on a
   second tensor and table) at the flip shapes of TTM and of the bench width;
   then the SCF's AO modes at the TTM shapes and, in f64, at TTM/dzp (K1 on
   two density matrices with o0 = v0 = 0 and nocc = nvir = nao, K2
   hermitian, K3 with the AO table on both sides, the whole grid in one
   launch), with ``library_ms`` the single einsum of the exchange and of the
   density (four rows, and the value row alone).  K1 sums in a fixed order
   in every mode; K2 and K3 run the AO modes in their fixed summation order,
   as the SCF runs them, with the atomic order timed beside, and the
   response shapes in the atomic order, with the fixed order timed beside
   (its cost).  Every fixed-order launch is made twice and must repeat
   bitwise.  The
   X-TDA shapes include TTM/dzp's alpha block in f64 (nz 20, naux 3990, nmo
   598; K2 and K3 on a 12-chunk jvp group);
3. the main path: X-TDA on the TTM radical (182 AO, ROKS/B3LYP, density
   fitted) through ``XTDA(load_mf(...), backend="df").kernel()`` in f64,
   gated against ``tests/data/golden_ttm.json``; every kernel must have
   launched in this run;
4. the bench-shape operator (nmo=1000, naux=2000, 49152 grid points, f32):
   one 20-vector sigma build against the plain path, then a 20-root solve;
5. the flip leg on the same TTM reference, f64: ``XSFTDA(ref, SA=0)`` and
   ``SFTDA(ref, extype="up")``, 10 roots each, gated against
   ``tests/data/golden_ttm_flip.json``; every kernel must have launched;
6. the flip leg at the bench width, f32: one ``xsf_sigma_df(SA=3)`` build
   against the plain path, seconds per build with the share of the
   spin-adaptation terms, then a 10-root solve;
7. the SCF on the Env of phase 3 (its grid and fitted tensors), f64: TTM
   ``ROKS(Molecule(ttm_vacuum), xc="b3lyp", grid_level=1, df=True).kernel()``
   from the GWH guess, gated against ``tests/data/ttm_ckpt.npz`` (the JAX
   package's DF SCF: energy and occupied orbital energies), with cycles,
   seconds and the kernel launches per cycle (every kernel must have
   launched on each Fock build), then once more with the device
   synchronized at each stage for the split of a cycle (the functional's
   share is the ``xc`` stage less phase 2's K3 time in AO mode); then
   ``XTDA(mf, nstates=10, backend="df")`` on that mean field, gated against
   ``golden_ttm.json`` like phase 3.  Both SCFs must take the same cycles
   and give the bitwise-same energy (the Fock build sums in a fixed order);
8. production scale, TTM/dzp (598 AO, naux 3990), f64, on one Env:
   ``load_mf`` of ``tests/data/ttm_dzp_ckpt.npz``, then ``XTDA(nstates=20)``
   and ``XSFTDA(SA=0)`` (10 roots, the flip golden's own arguments), each
   gated against the JAX package's own f64 solve of the same checkpoint (the
   ``DZP_JAX_*`` constants) with the goldens' deviations and TTM's E-pair
   splittings printed beside them; then the energy and orbital gradient of
   the checkpoint's own density under the port's Fock build, the ROKS SCF
   from ``geometries.ttm_vacuum`` and the STO-3G checkpoint projected to
   dzp (gated against the JAX host engine's energy of that density and the
   checkpoint's occupied orbital energies), and ``XTDA(nstates=5)`` on its
   mean field.  The set-up line gives each host step's seconds and the
   host's core count; every kernel must launch in every leg.

The line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  ``--out`` also writes every number to a
JSON file.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
F64_RTOL = 1e-11  # summation order differs from the plain version's
F32_RTOL = 1e-4
AO_RTOL = {"float64": 1e-12, "float32": 1e-5}  # the SCF's AO modes
TTM_GATE_EV = 5e-3  # the JAX DF path's own gate (tests/test_production.py)
SCF_GATE_HA = 1e-6  # TTM SCF energy against the JAX package's checkpoint
SCF_GATE_EPS_HA = 1e-5  # occupied orbital energies against it
# TTM/dzp (phase 8).  The goldens `golden_ttm_dzp*.json` and the stored
# e_tot of `ttm_dzp_ckpt.npz` come from the JAX package's mixed-precision
# production chain and are off the f64 DF operators (2.7-34 meV, 5e-5 Ha;
# TTM's D3 E pairs split by 4-17 meV in the goldens); they are printed, not
# gated.  The references instead: the JAX package's own f64 solve of the
# checkpoint, with the eigensolve of its DF drivers on its f64 X-TDA and
# XSF-TDA operators built on the host (`tools/ttm_dzp_ckpt_energy.py
# --solve`: roots in eV and the flip roots' <dS^2>), and the JAX host
# engine's energy of the checkpoint's density (the same run)
DZP_JAX_XTDA_EV = (
    2.493866335695523, 2.4947596334974476, 2.7333894812217863, 2.75117264466977,
    2.7514196252286487, 2.975365461290274, 3.534517250579991, 3.53483549264867,
    3.6532052618479813, 3.653225178921182, 3.7423195307368675, 3.742425347256728,
    3.826892874126782, 3.844602993641153, 3.920372347458342, 3.9204770591770863,
    3.9529553584399495, 3.9530748489699428, 3.967599961120482, 4.006207887011033,
)
DZP_JAX_XSF_EV = (
    2.3704744966592144, 2.3715599491004884, 2.6399184301523806, 2.652679245686194,
    2.6529959324296044, 2.8642980862106064, 3.2766252624137104, 3.2766805327957664,
    3.608756936802308, 3.6088008257894404,
)
DZP_JAX_XSF_DS2 = (
    0.0630150878278252, 0.06297461297139843, 0.059059304116762884, 0.06377323958381083,
    0.06375434632987974, 0.08115833559137343, 0.18184941497373333, 0.18201003239329974,
    0.047402001104889964, 0.047398436115701624,
)
DZP_JAX_E_OF_CKPT_DENSITY = -4868.533560419979
DZP_GATE_EV = 1e-4
DZP_GATE_DS2 = 1e-3
# X-TDA on the port's own SCF mean field (another mean field than the
# checkpoint's) against the roots of the checkpoint's: the JAX DF path's
# gate at 598 AO (tests/test_production.py)
DZP_SCF_XTDA_GATE_EV = 2e-3
# at dzp the kept fit metric spans a condition number of 2.1e14, so the
# few-ulp differences between two builds of the integral engine (the
# 2-center metric, the 3-center integrals) move the fitted energy: the port
# puts the checkpoint's density 5.7e-6 Ha below the JAX host engine
# (`tools/ttm_dzp_ckpt_energy.py --compare-fit` evaluates the JAX engine
# with the port's metric, then with its metric and j3c); about three times that
DZP_SCF_GATE_HA = 2e-5
# the dzp checkpoint was accepted by the JAX device engine at |g| ~ 1.8e-5,
# so its orbital energies carry that error
DZP_SCF_GATE_EPS_HA = 1e-4


def _log(*args):
    print(*args, flush=True)


def _sync():
    torch.cuda.synchronize()


def time_ms(fn, reps: int = 3) -> float:
    """Median of ``reps`` CUDA-event timed calls after one warm-up call."""
    fn()
    _sync()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        _sync()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rel_err(x: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |ref|)."""
    err = float((x - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-300)


def phase0() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} "
         f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    return {"nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda}


def phase1() -> dict:
    """Every build at once: the native engine and one nvcc per kernel source."""
    from concurrent.futures import ThreadPoolExecutor

    from xtddft_tpu_torch import kernels
    from xtddft_tpu_torch.buildlib import BUILD_SECONDS
    from xtddft_tpu_torch.ints import native

    with ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(native.load), pool.submit(kernels.build_all)]:
            f.result()
    _log("phase 1 builds (s):", json.dumps(BUILD_SECONDS))
    return dict(BUILD_SECONDS)


# (label, nz, naux, nmo, ((nocc, nvir) of the alpha and beta blocks), the
# grid chunks of one jvp group, the span K2 and K3 take in one launch, the
# dtypes checked)
F64_ONLY = (torch.float64,)
BOTH = (torch.float64, torch.float32)
MAIN_SHAPES = (
    ("ttm", 10, 4412, 182, ((137, 45), (136, 46)), 23, BOTH),
    ("bench", 20, 2000, 1000, ((80, 920), (78, 922)), 12, BOTH),
    ("dzp", 20, 3990, 598, ((137, 461), (136, 462)), 12, F64_ONLY),
)
# K1 edge cases, checked but not timed: (label, nz, naux, nmo, nocc, nvir)
K1_EDGES = (
    ("nocc300_odd_naux", 4, 257, 340, 300, 40),
    ("nvir_below_tile", 3, 100, 60, 50, 10),
    ("nz1", 1, 96, 120, 30, 90),
)


# spin-flip shapes: (label, nz, naux, nmo, n_o, v0, n_v, grid points of one
# span, second tensor and table on the virtual side); o = [0, n_o),
# v = [v0, v0 + n_v)
FLIP_SHAPES = (
    ("ttm_down", 10, 4412, 182, 137, 136, 46, 187644, False),
    ("ttm_up", 10, 4412, 182, 136, 137, 45, 187644, True),
    ("bench_down", 10, 2000, 1000, 80, 78, 922, 49152, False),
)


def _check(checks, rec, kern, plain, timed, flops=None, nbytes=None, library=None, twin=None):
    """Hold kern() against plain() (relative to max |plain|); time both
    and add the bound when ``timed``.  ``library``: one PyTorch call that
    computes the same function (a single multi-operand einsum), where there
    is one: held against plain() and timed for ``library_ms``; the port
    never calls it.  None where the function has two outputs or is a sum of
    products.  ``rec["fixed_order"]``: kern sums in a fixed order, so a
    second launch must repeat the first bitwise.  ``twin``: the same kernel
    in its other summation order, held against plain() too; the fixed-order
    one of the two is launched twice and must repeat bitwise; ``twin_ms`` is
    its time and ``fixed_order_cost`` the fixed order's time over the atomic
    order's, less one."""
    got = kern()
    _sync()
    want = plain()
    _sync()
    rec["max_abs_err"], rec["rel_err"] = rel_err(got, want)
    other = None
    if twin is not None:
        other = twin()
        rec["twin_rel_err"] = rel_err(other, want)[1]
    if rec.get("fixed_order") or twin is not None:
        fixed, again = (got, kern()) if rec.get("fixed_order") else (other, twin())
        rec["fixed_repeats_bitwise"] = bool(torch.equal(fixed, again))
        del fixed, again
    del got, other
    if library is not None:
        rec["library_rel_err"] = rel_err(library(), want)[1]
    del want
    if timed:
        from xtddft_tpu_torch.response.flops import bound_ms

        rec["ms"] = time_ms(kern)
        rec["plain_ms"] = time_ms(plain)  # the cuBLAS einsum route of the JAX code
        rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes, rec["dtype"])
        rec["library_ms"] = None if library is None else time_ms(library)
        if twin is not None:
            rec["twin_ms"] = time_ms(twin)
            fixed_ms, atomic_ms = ((rec["ms"], rec["twin_ms"]) if rec["fixed_order"]
                                   else (rec["twin_ms"], rec["ms"]))
            rec["fixed_order_cost"] = fixed_ms / atomic_ms - 1.0
    _log("phase 2", json.dumps(rec))
    if not rec["rel_err"] <= rec["rtol"]:
        raise AssertionError(f"{rec['kernel']} disagrees with its plain version: {rec}")
    if not rec.get("library_rel_err", 0.0) <= rec["rtol"]:
        raise AssertionError(f"{rec['kernel']}: the library call computes another function: {rec}")
    if twin is not None and not rec["twin_rel_err"] <= rec["rtol"]:
        raise AssertionError(f"{rec['kernel']}: its other summation order disagrees: {rec}")
    if not rec.get("fixed_repeats_bitwise", True):
        raise AssertionError(f"{rec['kernel']}: two fixed-order launches differ: {rec}")
    checks.append(rec)


def phase2() -> dict:
    """Each kernel against its plain version, f64 and f32, TTM and bench
    shapes, both spin blocks (times and bounds at the alpha block); K2 and
    K3 on one chunk and on the span of one jvp group; the spin-flip modes at
    the flip shapes; K1 at its edge cases."""
    from xtddft_tpu_torch.kernels import df_exchange as k1
    from xtddft_tpu_torch.kernels import grid_back as k3
    from xtddft_tpu_torch.kernels import grid_rho1 as k2
    from xtddft_tpu_torch.response import flops as fl

    g = torch.Generator("cuda").manual_seed(1234)
    checks = []
    gc = 4096
    for dtype in (torch.float64, torch.float32):
        tol = F64_RTOL if dtype == torch.float64 else F32_RTOL
        dname = str(dtype).split(".")[-1]
        isz = torch.empty((), dtype=dtype).element_size()
        for label, nz, naux, nmo, blocks, nspan, dtypes in MAIN_SHAPES:
            if dtype not in dtypes:
                continue
            G = torch.randn((naux, nmo, 8), generator=g, device="cuda", dtype=dtype)
            B = torch.bmm(G, G.transpose(1, 2)) / (naux * nmo * 8) ** 0.5
            del G
            span = nspan * gc
            # grid points as the sigma sees them: strided views of a padded table
            phi_all = torch.randn((4, gc + span, nmo), generator=g, device="cuda",
                                  dtype=dtype) / nmo ** 0.5
            phi = phi_all[:, gc:2 * gc]
            phi_span = phi_all[:, gc:gc + span]
            mask_span = (torch.rand(span, generator=g, device="cuda") > 0.05).to(dtype)
            for spin, (no, nv) in zip("ab", blocks):
                z = torch.randn((nz, no, nv), generator=g, device="cuda", dtype=dtype)
                dwv = torch.randn((nz, span), generator=g, device="cuda", dtype=dtype)
                dwg = torch.randn((nz, 3, span), generator=g, device="cuda", dtype=dtype)
                out = torch.zeros((nz, no, nv), device="cuda", dtype=dtype)
                timed = spin == "a"

                def rec(name, **kw):
                    return {"kernel": name, "shape": label, "spin": spin, "dtype": dname,
                            "nz": nz, "naux": naux, "nmo": nmo, "nocc": no, "nvir": nv,
                            "rtol": tol, "fixed_order": False, **kw}

                # K1 sums in its fixed order on every path; K2 and K3 in the
                # sigma's order (atomics), their fixed-order twins timed beside
                _check(checks, rec(k1.NAME, fixed_order=True),
                       lambda: torch.cat([x.flatten() for x in k1.df_exchange(B, z, 0, no)]),
                       lambda: torch.cat([x.flatten() for x in
                                          k1.df_exchange_plain(B, z, 0, no)]),
                       timed, fl.df_exchange_flops(naux, nz, no, nv),
                       fl.df_exchange_bytes(naux, nz, no, nv, isz))
                for pts, ph in ((gc, phi), (span, phi_span)):
                    mk = mask_span[:pts]
                    _check(checks, rec(k2.NAME, gc=pts),
                           lambda: k2.grid_rho1(ph, z, 0, no, mk),
                           lambda: k2.grid_rho1_plain(ph, z, 0, no, mk),
                           timed, fl.grid_rho1_flops(nz, no, nv, pts),
                           fl.grid_rho1_bytes(nz, no, nv, pts, isz),
                           twin=(lambda: k2.grid_rho1(ph, z, 0, no, mk, fixed_order=True))
                           if timed else None)
                one_chunk = (gc, phi, dwv[:, :gc].contiguous(), dwg[..., :gc].contiguous())
                for pts, ph, dv, dg in (one_chunk, (span, phi_span, dwv, dwg)):
                    _check(checks, rec(k3.NAME, gc=pts),
                           lambda: k3.grid_back(dv, dg, ph, 0, no, out.zero_()).clone(),
                           lambda: k3.grid_back_plain(dv, dg, ph, 0, no, out.zero_()).clone(),
                           timed, fl.grid_back_flops(nz, no, nv, pts),
                           fl.grid_back_bytes(nz, no, nv, pts, isz),
                           twin=(lambda: k3.grid_back(dv, dg, ph, 0, no, out.zero_(),
                                                      fixed_order=True).clone())
                           if timed else None)
            del B, phi_all, phi, phi_span, mask_span
            torch.cuda.empty_cache()
        for label, nz, naux, nmo, n_o, v0, n_v, npts, two in FLIP_SHAPES:
            def sym_b():
                G = torch.randn((naux, nmo, 8), generator=g, device="cuda", dtype=dtype)
                return torch.bmm(G, G.transpose(1, 2)) / (naux * nmo * 8) ** 0.5

            def table():
                return torch.randn((4, npts, nmo), generator=g, device="cuda",
                                   dtype=dtype) / nmo ** 0.5

            B, Bv = sym_b(), (sym_b() if two else None)
            z = torch.randn((nz, n_o, n_v), generator=g, device="cuda", dtype=dtype)
            o, v = slice(0, n_o), slice(v0, v0 + n_v)

            def rec(name, mode):
                return {"kernel": name, "shape": label, "mode": mode, "dtype": dname, "nz": nz,
                        "naux": naux, "nmo": nmo, "nocc": n_o, "v0": v0, "nvir": n_v,
                        "two_tables": two, "rtol": tol}

            _check(checks, {**rec(k1.NAME, "exchange_only"), "fixed_order": True},
                   lambda: k1.df_exchange(B, z, 0, v0, B_vir=Bv, with_t=False)[1],
                   lambda: k1.df_exchange_plain(B, z, 0, v0, B_vir=Bv, with_t=False)[1],
                   True, fl.df_exchange_flops(naux, nz, n_o, n_v, with_t=False),
                   fl.df_exchange_bytes(naux, nz, n_o, n_v, isz, with_t=False),
                   # operands in the order of the cheap pairwise path
                   library=lambda: torch.einsum("Pab,xjb,Pji->xia",
                                                (B if Bv is None else Bv)[:, v, v], z,
                                                B[:, o, o]))
            del B, Bv
            phi, phi_v = table(), (table() if two else None)
            wv = torch.randn((nz, 4, npts), generator=g, device="cuda", dtype=dtype)
            dwv, dwg = wv[:, 0].contiguous(), wv[:, 1:4].contiguous()
            del wv
            out = torch.zeros((nz, n_o, n_v), device="cuda", dtype=dtype)
            pv = phi if phi_v is None else phi_v
            # the value-only modes are one three-operand einsum each
            libs = {1: (lambda: torch.einsum("xov,gv,go->xg", z, pv[0][:, v],
                                             phi[0][:, o])[:, None],
                        lambda: torch.einsum("xg,go,gv->xov", dwv, phi[0][:, o], pv[0][:, v])),
                    4: (None, None)}
            for ncomp, mode in ((1, "value_only"), (4, "four_component")):
                dg = dwg if ncomp == 4 else None
                lib2, lib3 = libs[ncomp]
                _check(checks, {**rec(k2.NAME, mode), "gc": npts},
                       lambda: k2.grid_rho1(phi, z, 0, v0, None, phi_v=phi_v, ncomp=ncomp),
                       lambda: k2.grid_rho1_plain(phi, z, 0, v0, None, phi_v=phi_v,
                                                  ncomp=ncomp),
                       True, fl.grid_rho1_flops(nz, n_o, n_v, npts, ncomp),
                       fl.grid_rho1_bytes(nz, n_o, n_v, npts, isz, ncomp, masked=False),
                       library=lib2)
                _check(checks, {**rec(k3.NAME, mode), "gc": npts},
                       lambda: k3.grid_back(dwv, dg, phi, 0, v0, out.zero_(),
                                            phi_v=phi_v).clone(),
                       lambda: k3.grid_back_plain(dwv, dg, phi, 0, v0, out.zero_(),
                                                  phi_v=phi_v).clone(),
                       True, fl.grid_back_flops(nz, n_o, n_v, npts, ncomp),
                       fl.grid_back_bytes(nz, n_o, n_v, npts, isz, ncomp), library=lib3)
            del phi, phi_v, pv, dwv, dwg, out, libs
            torch.cuda.empty_cache()
        for shape in AO_SHAPES:
            if dtype in shape[-1]:
                _ao_checks(checks, g, dtype, *shape[:-1])
        for label, nz, naux, nmo, no, nv in K1_EDGES:
            B = torch.randn((naux, nmo, nmo), generator=g, device="cuda", dtype=dtype)
            z = torch.randn((nz, no, nv), generator=g, device="cuda", dtype=dtype)
            # o and v blocks at offsets, as the beta block of a sigma reads them
            o0, v0 = nmo - no - nv, nmo - nv
            _check(checks, {"kernel": k1.NAME, "shape": label, "spin": "a", "dtype": dname,
                            "nz": nz, "naux": naux, "nmo": nmo, "nocc": no, "nvir": nv,
                            "rtol": tol, "fixed_order": True},
                   lambda: torch.cat([x.flatten() for x in k1.df_exchange(B, z, o0, v0)]),
                   lambda: torch.cat([x.flatten() for x in k1.df_exchange_plain(B, z, o0, v0)]),
                   False)
    return {"checks": checks}


# the SCF's AO modes: (label, nao, naux, grid points, dtypes), two density
# matrices; TTM/STO-3G and TTM/dzp
AO_SHAPES = (("ttm_ao", 182, 4412, 187644, BOTH), ("dzp_ao", 598, 3990, 187644, F64_ONLY))
# the JAX functions each kernel computes in the SCF's Fock build
SCF_REPLACES = {"df_exchange": "xtddft_tpu/scf/env.py:244",
                "grid_rho1": "xtddft_tpu/xc/interface.py:53",
                "grid_back": "xtddft_tpu/xc/interface.py:112"}


def _ao_checks(checks, g, dtype, label, nao, naux, npts):
    """The SCF's Fock build on the kernels, in their fixed summation order
    as the SCF runs them, K2 and K3 each beside its atomic order: K1 in AO mode (t
    and K of two density matrices; timed and held against the single
    einsum on K, and checked untimed on (t, K)), K2 hermitian (four rows,
    and the value row alone, each against its single einsum), K3 with the
    AO table on both sides (no single call: a sum of three products)."""
    from xtddft_tpu_torch.kernels import df_exchange as k1
    from xtddft_tpu_torch.kernels import grid_back as k3
    from xtddft_tpu_torch.kernels import grid_rho1 as k2
    from xtddft_tpu_torch.response import flops as fl

    nz = 2
    dname = str(dtype).split(".")[-1]
    isz = torch.empty((), dtype=dtype).element_size()
    G = torch.randn((naux, nao, 8), generator=g, device="cuda", dtype=dtype)
    B = torch.bmm(G, G.transpose(1, 2)) / (naux * nao * 8) ** 0.5
    del G
    c = torch.randn((nz, nao, 60), generator=g, device="cuda", dtype=dtype) / 60 ** 0.5
    dms = c @ c.transpose(1, 2)  # symmetric, one per spin
    del c

    def rec(name, mode, **kw):
        return {"kernel": name, "shape": label, "mode": mode, "dtype": dname, "nz": nz,
                "nao": nao, "naux": naux, "rtol": AO_RTOL[dname], "fixed_order": True, **kw}

    _check(checks, rec(k1.NAME, "ao"), lambda: k1.df_exchange(B, dms, 0, 0)[1],
           lambda: k1.df_exchange_plain(B, dms, 0, 0)[1], True,
           fl.df_exchange_flops(naux, nz, nao, nao), fl.df_exchange_bytes(naux, nz, nao, nao, isz),
           library=lambda: torch.einsum("Pmr,xrs,Psn->xmn", B, dms, B))
    _check(checks, rec(k1.NAME, "ao_with_t"),
           lambda: torch.cat([x.flatten() for x in k1.df_exchange(B, dms, 0, 0)]),
           lambda: torch.cat([x.flatten() for x in k1.df_exchange_plain(B, dms, 0, 0)]), False)
    del B
    torch.cuda.empty_cache()
    ao = torch.randn((4, npts, nao), generator=g, device="cuda", dtype=dtype) / nao ** 0.5
    wv = torch.randn((nz, 4, npts), generator=g, device="cuda", dtype=dtype)
    dwv, dwg = wv[:, 0].contiguous(), wv[:, 1:4].contiguous()
    del wv
    nbytes = fl.grid_ao_bytes(nz, nao, npts, isz)
    # for a symmetric D the gradient rows are 2 sum grad(phi) D phi
    rows = torch.tensor([1.0, 2.0, 2.0, 2.0], device="cuda", dtype=dtype)
    _check(checks, rec(k2.NAME, "hermi", gc=npts),
           lambda: k2.grid_rho1(ao, dms, 0, 0, hermi=True, fixed_order=True),
           lambda: k2.grid_rho1_plain(ao, dms, 0, 0, hermi=True), True,
           fl.grid_ao_flops(nz, nao, npts), nbytes,
           library=lambda: torch.einsum("c,cgi,xij,gj->xcg", rows, ao, dms, ao[0]),
           twin=lambda: k2.grid_rho1(ao, dms, 0, 0, hermi=True))
    _check(checks, rec(k2.NAME, "hermi_value_only", gc=npts),
           lambda: k2.grid_rho1(ao, dms, 0, 0, ncomp=1, hermi=True, fixed_order=True),
           lambda: k2.grid_rho1_plain(ao, dms, 0, 0, ncomp=1, hermi=True), True,
           fl.grid_rho1_flops(nz, nao, nao, npts, 1),
           fl.grid_rho1_bytes(nz, nao, nao, npts, isz, 1, masked=False),
           library=lambda: torch.einsum("gi,xij,gj->xg", ao[0], dms, ao[0])[:, None],
           twin=lambda: k2.grid_rho1(ao, dms, 0, 0, ncomp=1, hermi=True))
    out = torch.zeros((nz, nao, nao), device="cuda", dtype=dtype)
    _check(checks, rec(k3.NAME, "ao", gc=npts),
           lambda: k3.grid_back(dwv, dwg, ao, 0, 0, out.zero_(), fixed_order=True).clone(),
           lambda: k3.grid_back_plain(dwv, dwg, ao, 0, 0, out.zero_()).clone(), True,
           fl.grid_ao_flops(nz, nao, npts), nbytes,
           twin=lambda: k3.grid_back(dwv, dwg, ao, 0, 0, out.zero_()).clone())
    del ao, dwv, dwg, out, dms
    torch.cuda.empty_cache()


def _first_fxc_jvp():
    """The first torch.func transform of a process loads its decompositions
    and imports (~10 s); pay that in the set-up, not in the timed solve."""
    from xtddft_tpu_torch.xc import interface, registry

    respond = interface.make_fxc_jvp(registry.resolve("b3lyp"))
    r = torch.ones(8, device="cuda", dtype=torch.float64)
    g = torch.zeros((3, 8), device="cuda", dtype=torch.float64)
    torch.func.vmap(lambda d: respond(r, (r, r, g, g), d))((r[None], r[None], g[None], g[None]))


def phase3():
    """The main path: TTM X-TDA, f64, through the public entry point.
    Returns (record, the Reference) for the flip leg to reuse."""
    from xtddft_tpu_torch import kernels
    from xtddft_tpu_torch.methods.drivers import XTDA
    from xtddft_tpu_torch.response.reference_state import make_reference
    from xtddft_tpu_torch.scf.checkpoint import load_mf

    golden = json.loads((ROOT / "tests/data/golden_ttm.json").read_text())
    e_ref = np.asarray(golden["xtda_e_ev"])
    t = {}
    t0 = time.perf_counter()
    mf = load_mf(str(ROOT / "tests/data/ttm_ckpt.npz"), df=True, device="cuda",
                 dtype=torch.float64)
    env = mf.env
    steps = (
        ("grid", lambda: env.grid),
        ("eval_ao", lambda: env.ao),
        ("j3c", env.df_j3c_host),
        ("metric", env.df_isqrt_host),
        ("one_electron_props", lambda: (env.dip, env.ipovlp, env.rxp)),
        ("make_reference", lambda: make_reference(mf)),
        ("torch_func_first_use", _first_fxc_jvp),
    )
    for name, step in steps:
        s = time.perf_counter()
        out = step()
        _sync()
        t[name] = time.perf_counter() - s
        if name == "make_reference":
            ref = out
    t["host_setup"] = time.perf_counter() - t0
    dims = {"nao": env.nao, "naux": env.aux_layout.nao, "ngrid": int(env.grid.size),
            "nc": ref.nc, "no": ref.no, "nv": ref.nv}
    _log("phase 3 setup", json.dumps({**dims, **t}))

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    s = time.perf_counter()
    res = XTDA(ref, nstates=10, backend="df").kernel()
    _sync()
    t["solve"] = time.perf_counter() - s
    launches = kernels.launch_counts()
    dev = float(np.abs(res.e_eV - e_ref[: len(res.e_eV)]).max())
    rec = {**dims, **t, "launches": launches, "cycles": res.cycles,
           "nroots": len(res.e), "converged": res.converged, "max_dev_ev": dev,
           "e_ev": res.e_eV.tolist(), "osc": res.osc.tolist(), "ds2": res.ds2.tolist(),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    _log("phase 3 solve", json.dumps(rec))
    if not (res.converged and len(res.e) == 10):
        raise AssertionError(f"TTM X-TDA: not 10/10 roots converged: {rec}")
    if not dev < TTM_GATE_EV:
        raise AssertionError(f"TTM X-TDA deviates from golden_ttm.json by {dev} eV")
    if not (np.all(res.osc >= -1e-12) and np.all(np.isfinite(res.ds2))):
        raise AssertionError(f"TTM X-TDA: negative osc or non-finite ds2: {rec}")
    idle = [k for k, n in launches.items() if n <= 0]
    if idle:
        raise AssertionError(f"kernels not launched on the main path: {idle}")
    return rec, ref


def phase7(mf0, e_phase3, k3_ms) -> dict:
    """The SCF of the port on the Env of phase 3's mean field ``mf0`` (the
    checkpoint's), f64, from the GWH guess, then X-TDA on its mean field;
    both through the public entry points.  Also the energy of the
    checkpoint's own density by the port's Fock build, which tells a
    difference of densities from one of the energy expression.
    ``k3_ms``: phase 2's time of K3 in AO mode, f64, which the ``xc``
    stage (the functional and K3) holds once a cycle."""
    from xtddft_tpu_torch import kernels
    from xtddft_tpu_torch.chem import Molecule, geometries
    from xtddft_tpu_torch.methods.drivers import XTDA
    from xtddft_tpu_torch.response.flops import scf_veff_flops
    from xtddft_tpu_torch.scf import ROKS

    golden = json.loads((ROOT / "tests/data/golden_ttm.json").read_text())
    ckpt = np.load(ROOT / "tests/data/ttm_ckpt.npz")
    env = mf0.env
    mol = Molecule.from_atoms(geometries.ttm_vacuum, basis="sto-3g", spin=1)
    if mol != env.mol:
        raise AssertionError("ttm_vacuum is not the molecule of tests/data/ttm_ckpt.npz")
    scf = ROKS(mol, xc="b3lyp", grid_level=1, df=True, env=env)
    kernels.reset_launch_counts()
    s = time.perf_counter()
    mf = scf.kernel()
    _sync()
    wall = time.perf_counter() - s
    launches = kernels.launch_counts()
    occ = np.asarray(ckpt["mo_occ"]) > 0
    d_e = mf.e_tot - float(ckpt["e_tot"])
    d_eps = float(np.abs(mf.mo_energy[occ] - np.asarray(ckpt["mo_energy"])[occ]).max())
    n = scf.cycles
    # the same SCF again, the device synchronized at each stage of a Fock
    # build, for the split of a cycle; the Fock build sums in a fixed order,
    # so it must take the same cycles to the bitwise-same energy (at 4814 Ha
    # the energy test of 1e-11 Ha sits at the rounding of those sums)
    scf.profile = True
    s = time.perf_counter()
    mf_prof = scf.kernel()
    _sync()
    wall_profiled = time.perf_counter() - s
    n_prof = scf.cycles
    stages = dict(scf.stage_seconds)
    k3_s = k3_ms / 1e3 * n_prof
    fl = scf_veff_flops(env.aux_layout.nao, env.nao, int(env.grid.size))
    d0 = mf0.make_rdm1()
    e2 = scf._veff_and_exc(d0[0], d0[1])[2]
    e_of_ckpt_density = (float(np.einsum("pq,qp->", env.hcore.cpu().numpy(), d0[0] + d0[1]))
                         + e2 + mol.energy_nuc())
    rec = {"cycles": n, "converged": mf.converged, "scf_s": wall, "s_per_cycle": wall / n,
           "scf_profiled_s": wall_profiled, "cycles_profiled": n_prof,
           "e_tot_profiled_minus_e_tot_ha": mf_prof.e_tot - mf.e_tot,
           "stage_s_per_cycle": {k: v / n_prof for k, v in stages.items()},
           "functional_s_per_cycle": (stages["xc"] - k3_s) / n_prof,
           "k3_s_per_cycle": k3_s / n_prof,
           "launches": launches, "launches_per_cycle": {k: v / n for k, v in launches.items()},
           "e_tot": mf.e_tot, "de_vs_ckpt_ha": d_e,
           "de_vs_golden_e_scf_ha": mf.e_tot - float(golden["e_scf"]),
           "max_deps_occ_ha": d_eps, "flops_per_cycle": fl["total"],
           "kernel_tflops": fl["total"] / (stages["jk"] + stages["rho"] + k3_s)
                            * n_prof / 1e12,
           "e_of_ckpt_density_minus_ckpt_e_tot_ha": e_of_ckpt_density - float(ckpt["e_tot"]),
           "e_tot_minus_e_of_ckpt_density_ha": mf.e_tot - e_of_ckpt_density}
    _log("phase 7 scf", json.dumps(rec))
    if not mf.converged:
        raise AssertionError(f"TTM SCF did not converge: {rec}")
    if not abs(d_e) <= SCF_GATE_HA:
        raise AssertionError(f"TTM SCF energy off the checkpoint's by {d_e} Ha")
    if not d_eps <= SCF_GATE_EPS_HA:
        raise AssertionError(f"TTM SCF occupied orbital energies off by {d_eps} Ha")
    short = [k for k, v in launches.items() if v < n]
    if short:
        raise AssertionError(f"kernels not launched on every Fock build: {short} {launches}")
    if not (n_prof == n and mf_prof.e_tot == mf.e_tot):
        raise AssertionError(f"a second SCF on the same input took {n_prof} cycles to "
                             f"{mf_prof.e_tot!r} Ha, the first {n} to {mf.e_tot!r} Ha")

    e_ref = np.asarray(golden["xtda_e_ev"])
    kernels.reset_launch_counts()
    s = time.perf_counter()
    res = XTDA(mf, nstates=10, backend="df").kernel()
    _sync()
    xt = {"solve_s": time.perf_counter() - s, "launches": kernels.launch_counts(),
          "cycles": res.cycles, "nroots": len(res.e), "converged": res.converged,
          "max_dev_ev": float(np.abs(res.e_eV - e_ref[: len(res.e_eV)]).max()),
          "max_dev_vs_phase3_ev": float(np.abs(res.e_eV - np.asarray(e_phase3)).max()),
          "e_ev": res.e_eV.tolist()}
    _log("phase 7 xtda", json.dumps(xt))
    if not (res.converged and len(res.e) == 10):
        raise AssertionError(f"X-TDA on the port's SCF: not 10/10 roots converged: {xt}")
    if not xt["max_dev_ev"] < TTM_GATE_EV:
        raise AssertionError(f"X-TDA on the port's SCF deviates from golden_ttm.json: {xt}")
    idle = [k for k, v in xt["launches"].items() if v <= 0]
    if idle:
        raise AssertionError(f"kernels not launched on the SCF's X-TDA: {idle}")
    rec["xtda"] = xt
    return rec


def _roks_gradient(scf, mf, va, vb):
    """|g| of the Roothaan Fock of the potentials (va, vb) at mf's density,
    the SCF's own convergence measure (`scf/driver.py`)."""
    from xtddft_tpu_torch.scf.driver import _sym_orth

    env = scf.env
    S = env.S.cpu().numpy()
    h = env.hcore.cpu().numpy()
    da, db = mf.make_rdm1()
    f = scf._roothaan_fock(h + va, h + vb, db, da - db, S)
    X = _sym_orth(S)
    return float(np.linalg.norm(X.T @ (f @ (da + db) @ S - S @ (da + db) @ f) @ X))


def _pair_splits(e_ev, pairs):
    """e[i + 1] - e[i] for the doubly degenerate (E) pairs (i, i + 1) of TTM's
    D3 symmetry."""
    return [float(e_ev[i + 1] - e_ev[i]) for i in pairs]


def _solve_leg(name, run, want, golden, nroots, flops_per_build, failed, gate_ev=None):
    """One response solve of phase 8: wall, cycles, builds/s, TFLOP/s and
    launches; the gates: every root converged, the sorted roots within
    ``gate_ev`` (default ``DZP_GATE_EV``) of ``want[0]`` (the JAX package's
    f64 solve, `tools/ttm_dzp_ckpt_energy.py --solve`) and <dS^2> within
    ``DZP_GATE_DS2`` of ``want[1]`` where given, osc >= 0.  ``golden``:
    (energies, <dS^2> or None) of the JAX golden, printed beside the port's
    with the splittings of the E pairs, which D3 symmetry makes degenerate.
    A failed gate goes into ``failed``, which phase 8 raises on once every
    leg has printed."""
    from xtddft_tpu_torch import kernels

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    s = time.perf_counter()
    res = run()
    _sync()
    wall = time.perf_counter() - s
    launches = kernels.launch_counts()
    order = np.argsort(res.e_eV)
    e = res.e_eV[order]
    dev = e - np.sort(np.asarray(want[0]))[:nroots]
    g = np.sort(np.asarray(golden[0]))[:nroots]
    # the E pairs: neighbours within 2 meV in the port's spectrum
    pairs = [i for i in range(len(e) - 1) if e[i + 1] - e[i] < 2e-3]
    r = {"solve_s": wall, "cycles": res.cycles, "nroots": len(res.e),
         "converged": res.converged, "max_dev_ev": float(np.abs(dev).max()),
         "builds_per_s": res.cycles / wall,
         "tflops": flops_per_build * res.cycles / wall / 1e12,
         "flops_per_build": flops_per_build, "launches": launches,
         "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "e_ev": e.tolist(),
         "dev_ev": dev.tolist(), "golden_dev_ev": (e - g).tolist(),
         "max_golden_dev_ev": float(np.abs(e - g).max()),
         "e_pair_splits_ev": _pair_splits(e, pairs),
         "golden_e_pair_splits_ev": _pair_splits(g, pairs)}
    if res.osc is not None:
        r["osc_min"] = float(np.min(res.osc))
    if want[1] is not None:
        ds2 = np.asarray(res.ds2)[order]
        r["ds2"] = ds2.tolist()
        r["max_dev_ds2"] = float(np.abs(ds2 - np.asarray(want[1])[np.argsort(want[0])]).max())
        r["max_golden_dev_ds2"] = float(np.abs(
            ds2 - np.asarray(golden[1])[np.argsort(golden[0])]).max())
    _log(f"phase 8 {name}", json.dumps(r))
    if not (res.converged and len(res.e) == nroots):
        failed.append(f"TTM/dzp {name}: not {nroots}/{nroots} roots converged")
    if not r["max_dev_ev"] < (DZP_GATE_EV if gate_ev is None else gate_ev):
        failed.append(f"TTM/dzp {name} deviates from the JAX f64 solve by "
                      f"{r['max_dev_ev']} eV")
    if res.osc is not None and not np.all(res.osc >= -1e-12):
        failed.append(f"TTM/dzp {name}: negative oscillator strength {r['osc_min']}")
    if want[1] is not None and not r["max_dev_ds2"] < DZP_GATE_DS2:
        failed.append(f"TTM/dzp {name}: <dS^2> off by {r['max_dev_ds2']}")
    idle = [k for k, n in launches.items() if n <= 0]
    if idle:
        failed.append(f"kernels not launched on the dzp {name} path: {idle}")
    return r, res


def phase8(ref_small, rec: dict, vectors: pathlib.Path | None = None) -> dict:
    """Production scale: TTM/dzp (598 AO), f64, through the public entry
    points on one Env (``ref_small``: phase 3's STO-3G Reference, whose
    orbitals start the SCF).  The response from the checkpoint (X-TDA, 20
    roots; XSF-TDA SA=0, 10 roots), then the ROKS SCF from the STO-3G
    checkpoint projected to dzp and X-TDA on its mean field; the gates are
    listed with the ``DZP_*``
    constants.  Fills ``rec`` leg by leg (so that a failed
    gate leaves the numbers before it) and returns it; ``vectors``: also
    write the two response legs' roots and eigenvectors (blocked layout)
    there, for `tools/ttm_dzp_ckpt_energy.py --rayleigh`."""
    import os

    from xtddft_tpu_torch import kernels
    from xtddft_tpu_torch.chem import Molecule, geometries
    from xtddft_tpu_torch.methods.drivers import XSFTDA, XTDA
    from xtddft_tpu_torch.response.flops import matvec_flops, scf_veff_flops, sf_matvec_flops
    from xtddft_tpu_torch.response.reference_state import make_reference
    from xtddft_tpu_torch.response.sigma_df import build_df_data
    from xtddft_tpu_torch.scf import ROKS
    from xtddft_tpu_torch.scf.checkpoint import load_mf
    from xtddft_tpu_torch.scf.project import project_mo

    golden = json.loads((ROOT / "tests/data/golden_ttm_dzp.json").read_text())
    golden_xsf = json.loads((ROOT / "tests/data/golden_ttm_dzp_xsf.json").read_text())
    ckpt_path = ROOT / "tests/data/ttm_dzp_ckpt.npz"
    ckpt = np.load(ckpt_path)
    t = {"host_cores": os.cpu_count()}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mf0 = load_mf(str(ckpt_path), df=True, device="cuda", dtype=torch.float64)
    env, small = mf0.env, ref_small.env
    held = {}
    steps = (
        ("grid", lambda: env.grid),
        ("eval_ao", lambda: env.ao),
        ("j3c", env.df_j3c_host),
        ("metric", env.df_isqrt_host),
        ("dressing", env.df_B),
        ("one_electron", lambda: (env.S, env.hcore)),
        ("one_electron_props", lambda: (env.dip, env.ipovlp, env.rxp)),
        ("make_reference", lambda: held.setdefault("ref", make_reference(mf0))),
        ("build_df_data", lambda: build_df_data(held["ref"])),
    )
    for name, step in steps:
        s = time.perf_counter()
        step()
        _sync()
        t[name] = time.perf_counter() - s
    t["host_setup"] = time.perf_counter() - t0
    ref = held.pop("ref")
    naux, ngrid = env.aux_layout.nao, int(env.grid.size)
    dims = {"nao": env.nao, "naux": naux, "ngrid": ngrid, "nc": ref.nc, "no": ref.no,
            "nv": ref.nv, "j3c_released": not env._df_j3c_cache,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    _log("phase 8 setup", json.dumps({**dims, **t}))
    rec.update(dims, setup_s=t)
    failed = []
    # the checkpoint's own density under the port's Fock build
    mol = Molecule.from_atoms(geometries.ttm_vacuum, basis="dzp", spin=1)
    if mol != env.mol:
        raise AssertionError("ttm_vacuum is not the molecule of tests/data/ttm_dzp_ckpt.npz")
    scf = ROKS(mol, xc="b3lyp", grid_level=1, df=True, aux_mode="jk", env=env)
    d0 = mf0.make_rdm1()
    va, vb, e2 = scf._veff_and_exc(d0[0], d0[1])
    e_ckpt_density = (float(np.einsum("pq,qp->", env.hcore.cpu().numpy(), d0[0] + d0[1]))
                      + e2 + mol.energy_nuc())
    g_ckpt = _roks_gradient(scf, mf0, va, vb)
    rec["ckpt_density"] = {"e_minus_ckpt_e_tot_ha": e_ckpt_density - float(ckpt["e_tot"]),
                           "e_minus_jax_host_ha": e_ckpt_density - DZP_JAX_E_OF_CKPT_DENSITY,
                           "gnorm": g_ckpt}
    _log("phase 8 checkpoint density", json.dumps(rec["ckpt_density"]))

    n_o, n_v = ref.nc + ref.no, ref.no + ref.nv
    rec["xtda"], res_x = _solve_leg(
        "xtda", lambda: XTDA(ref, nstates=20, backend="df").kernel(),
        (DZP_JAX_XTDA_EV, None), (golden["e_refined_ev"], None), 20,
        matvec_flops(ref.nc, ref.no, ref.nv, naux, ngrid, 20), failed)
    # the flip golden's own arguments (bench.py's production flip leg)
    rec["xsf"], res_f = _solve_leg(
        "xsf", lambda: XSFTDA(ref, SA=int(golden_xsf["SA"]), backend="df").kernel(
            nstates=10, foo=1.0, fglobal=float(golden_xsf["fglobal"]), remove=True),
        (DZP_JAX_XSF_EV, DZP_JAX_XSF_DS2), (golden_xsf["e_refined_ev"], golden_xsf["ds2"]), 10,
        sf_matvec_flops(n_o, n_v, naux, ngrid, 10), failed)
    if vectors is not None:
        np.savez(vectors, xtda_e=res_x.e, xtda_v=res_x.v, xsf_e=res_f.e, xsf_v=res_f.v,
                 xsf_ds2=res_f.ds2)
    del res_x, res_f

    # the SCF from the STO-3G solution projected to dzp
    S = env.S.cpu().numpy()
    s = time.perf_counter()
    init = project_mo(ref_small.mf.mo_coeff, small.layout, env.layout, s_big=S)
    t_project = time.perf_counter() - s
    # synchronized at each stage of a Fock build: the split of a cycle (a
    # dzp cycle is long beside the synchronizations)
    scf.profile = True
    kernels.reset_launch_counts()
    s = time.perf_counter()
    mf = scf.kernel(init=init)
    _sync()
    wall = time.perf_counter() - s
    launches = kernels.launch_counts()
    n = scf.cycles
    occ = np.asarray(ckpt["mo_occ"]) > 0
    d_e = mf.e_tot - float(ckpt["e_tot"])
    d_eps = float(np.abs(mf.mo_energy[occ] - np.asarray(ckpt["mo_energy"])[occ]).max())
    stages = {k: v / n for k, v in scf.stage_seconds.items()}
    fl = scf_veff_flops(naux, env.nao, ngrid)
    sc = {"cycles": n, "converged": mf.converged, "scf_s": wall, "s_per_cycle": wall / n,
          "stage_s_per_cycle": stages, "k1_share_of_cycle": stages["jk"] / (wall / n),
          "project_s": t_project, "launches": launches,
          "e_tot": mf.e_tot, "de_vs_ckpt_ha": d_e,
          "de_vs_jax_host_ha": mf.e_tot - DZP_JAX_E_OF_CKPT_DENSITY, "max_deps_occ_ha": d_eps,
          "flops_per_cycle": fl, "k1_tflops": fl["k1"] / stages["jk"] / 1e12,
          "e_tot_minus_e_of_ckpt_density_ha": mf.e_tot - e_ckpt_density}
    _log("phase 8 scf", json.dumps(sc))
    if not mf.converged:
        failed.append(f"TTM/dzp SCF did not converge in {n} cycles")
    if not abs(sc["de_vs_jax_host_ha"]) <= DZP_SCF_GATE_HA:
        failed.append(f"TTM/dzp SCF energy off the JAX host engine's value by "
                      f"{sc['de_vs_jax_host_ha']} Ha")
    if not mf.e_tot <= e_ckpt_density:
        failed.append(f"TTM/dzp SCF energy above that of the checkpoint's density by "
                      f"{sc['e_tot_minus_e_of_ckpt_density_ha']} Ha")
    if not d_eps <= DZP_SCF_GATE_EPS_HA:
        failed.append(f"TTM/dzp SCF occupied orbital energies off by {d_eps} Ha")
    short = [k for k, v in launches.items() if v < n]
    if short:
        failed.append(f"kernels not launched on every dzp Fock build: {short} {launches}")
    rec["scf"] = sc
    # on a mean field re-converged under the port's own Fock build: the
    # roots of the checkpoint's within 2e-3 eV (DZP_SCF_XTDA_GATE_EV)
    rec["scf_xtda"], res = _solve_leg(
        "scf_xtda", lambda: XTDA(mf, nstates=5, backend="df").kernel(),
        (DZP_JAX_XTDA_EV[:5], None), (golden["e_refined_ev"], None), 5,
        matvec_flops(ref.nc, ref.no, ref.nv, naux, ngrid, 5), failed, gate_ev=DZP_SCF_XTDA_GATE_EV)
    rec["scf_xtda"]["max_dev_vs_ckpt_xtda_ev"] = float(
        np.abs(res.e_eV - np.asarray(rec["xtda"]["e_ev"][:5])).max())
    if failed:
        raise AssertionError("phase 8 (TTM/dzp): " + "; ".join(failed))
    return rec


def _plain_matvec(op, z):
    """op.matvec(z) with every kernel of the sigma swapped for its plain version."""
    from xtddft_tpu_torch.kernels import df_exchange as k1
    from xtddft_tpu_torch.kernels import grid_back as k3
    from xtddft_tpu_torch.kernels import grid_rho1 as k2
    from xtddft_tpu_torch.response import sigma_df

    swapped = {"df_exchange": k1.df_exchange_plain, "grid_rho1": k2.grid_rho1_plain,
               "grid_back": k3.grid_back_plain}
    saved = {n: getattr(sigma_df, n) for n in swapped}
    try:
        for n, f in swapped.items():
            setattr(sigma_df, n, f)
        want = op.matvec(z)
        _sync()
    finally:
        for n, f in saved.items():
            setattr(sigma_df, n, f)
    return want


def phase4():
    """Bench-shape synthetic operator, f32: sigma check and 20-root solve.
    Returns (record, the DFData) for the flip leg to reuse."""
    from xtddft_tpu_torch.response import sigma_df
    from xtddft_tpu_torch.response.flops import matvec_flops
    from xtddft_tpu_torch.solver.davidson import davidson

    nmo, nc, no, naux, ngrid, nroots = 1000, 78, 2, 2000, 49152, 20
    nv = nmo - nc - no
    g = torch.Generator("cuda").manual_seed(0)
    s = time.perf_counter()
    data = sigma_df.synthetic_df_data(nmo=nmo, nc=nc, no=no, naux=naux, ngrid=ngrid,
                                      xc="bhandhlyp", generator=g, device="cuda",
                                      dtype=torch.float32)
    op = sigma_df.xtda_sigma_df(data)
    _sync()
    t_build = time.perf_counter() - s

    z = torch.randn((nroots, op.dim), generator=g, device="cuda", dtype=torch.float32)
    z = z / z.norm(dim=1, keepdim=True)
    got = op.matvec(z)
    _sync()
    err, rel = rel_err(got, _plain_matvec(op, z))
    _log("phase 4 sigma", json.dumps({"max_abs_err": err, "rel_err": rel,
                                      "rtol": F32_RTOL, "t_data_s": t_build}))
    if not rel <= F32_RTOL:
        raise AssertionError(f"bench sigma: kernels vs plain rel {rel}")

    x0 = op.init_guess(nroots)
    nb = x0.shape[0]
    torch.cuda.reset_peak_memory_stats()
    s = time.perf_counter()
    e, _, conv, info = davidson(op.matvec, op.hdiag, nroots=nroots, init_guess=x0,
                                tol=1e-3, max_space_factor=8, device=op.device,
                                dtype=op.dtype)
    _sync()
    wall = time.perf_counter() - s
    cycles = info["cycles"]
    flops = matvec_flops(nc, no, nv, naux, ngrid, nb)
    rec = {"wall_s": wall, "cycles": cycles, "nb": nb, "nconv": int(conv.sum()),
           "nroots": nroots, "builds_per_s": cycles / wall,
           "tflops": flops * cycles / wall / 1e12, "flops_per_build": flops,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "e": e.tolist()}
    _log("phase 4 solve", json.dumps(rec))
    if not (conv.sum() == nroots and np.all(np.isfinite(e)) and np.all(np.diff(e) >= 0)):
        raise AssertionError(f"bench solve: {rec}")
    return rec, data


def phase5(ref) -> dict:
    """The flip leg on the TTM reference of phase 3, f64, through the public
    entry points: XSF-TDA (SA=0: TTM is a doublet) and SF-TDA flip-up."""
    from xtddft_tpu_torch import kernels
    from xtddft_tpu_torch.methods.drivers import SFTDA, XSFTDA

    golden = json.loads((ROOT / "tests/data/golden_ttm_flip.json").read_text())
    runs = (
        ("xsf", lambda: XSFTDA(ref, nstates=10, SA=0, method=0, backend="df").kernel(),
         golden["xsf_e_ev"], golden["xsf_ds2"]),
        ("sfup", lambda: SFTDA(ref, nstates=10, extype="up", method=0, backend="df").kernel(),
         golden["sfup_e_ev"], None),
    )
    rec = {}
    for name, run, e_ref, ds2_ref in runs:
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        s = time.perf_counter()
        res = run()
        _sync()
        wall = time.perf_counter() - s
        launches = kernels.launch_counts()
        # the golden has near-degenerate pairs: compare sorted energies, not vectors
        order = np.argsort(res.e_eV)
        dev = float(np.abs(res.e_eV[order] - np.sort(e_ref)).max())
        r = {"solve_s": wall, "cycles": res.cycles, "nroots": len(res.e),
             "converged": res.converged, "max_dev_ev": dev, "launches": launches,
             "e_ev": res.e_eV.tolist(),
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if ds2_ref is not None:
            r["ds2"] = res.ds2.tolist()
            r["max_dev_ds2"] = float(np.abs(
                res.ds2[order] - np.asarray(ds2_ref)[np.argsort(e_ref)]).max())
        _log(f"phase 5 {name}", json.dumps(r))
        if not (res.converged and len(res.e) == 10):
            raise AssertionError(f"TTM {name}: not 10/10 roots converged: {r}")
        if not dev < TTM_GATE_EV:
            raise AssertionError(f"TTM {name} deviates from golden_ttm_flip.json by {dev} eV")
        if ds2_ref is not None and not r["max_dev_ds2"] < 1e-3:
            raise AssertionError(f"TTM {name}: <dS^2> off by {r['max_dev_ds2']}")
        idle = [k for k, n in launches.items() if n <= 0]
        if idle:
            raise AssertionError(f"kernels not launched on the {name} path: {idle}")
        rec[name] = r
    rec["launches"] = {k: rec["xsf"]["launches"][k] + rec["sfup"]["launches"][k]
                       for k in rec["xsf"]["launches"]}
    return rec


def phase6(data) -> dict:
    """The flip leg at the bench width, f32, on the DFData of phase 4:
    ``xsf_sigma_df(SA=3, remove=True, method=0)`` against the plain path,
    seconds per build and the spin-adaptation (dA) share, a 10-root solve."""
    from xtddft_tpu_torch import kernels
    from xtddft_tpu_torch.response import sigma_df, xsf_terms
    from xtddft_tpu_torch.response.flops import sf_matvec_flops
    from xtddft_tpu_torch.solver.davidson import davidson

    nroots = 10
    n_o, n_v = data.nc + data.no, data.no + data.nv
    naux, ngrid = data.B.shape[0], data.grid_w.shape[0]
    s = time.perf_counter()
    xsf_terms.delta_a_tensors_from_df(data.B, data.nc, data.no, 3)
    _sync()
    t_da_tensors = time.perf_counter() - s
    s = time.perf_counter()
    op = sigma_df.xsf_sigma_df(data, SA=3, remove=True, method=0)
    _sync()
    t_op = time.perf_counter() - s
    op_sa0 = sigma_df.xsf_sigma_df(data, SA=0, remove=True, method=0)

    g = torch.Generator("cuda").manual_seed(6)
    z = torch.randn((nroots, op.dim), generator=g, device="cuda", dtype=torch.float32)
    z = z / z.norm(dim=1, keepdim=True)
    kernels.reset_launch_counts()
    got = op.matvec(z)
    _sync()
    launches = kernels.launch_counts()
    err, rel = rel_err(got, _plain_matvec(op, z))
    build_ms = time_ms(lambda: op.matvec(z))
    build_sa0_ms = time_ms(lambda: op_sa0.matvec(z))
    sig = {"max_abs_err": err, "rel_err": rel, "rtol": F32_RTOL, "dim": op.dim,
           "launches_per_build": launches, "build_ms": build_ms,
           "build_without_dA_ms": build_sa0_ms,
           "dA_share": (build_ms - build_sa0_ms) / build_ms,
           "dA_tensors_s": t_da_tensors, "operator_s": t_op}
    _log("phase 6 sigma", json.dumps(sig))
    if not rel <= F32_RTOL:
        raise AssertionError(f"bench flip sigma: kernels vs plain rel {rel}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"bench flip sigma: kernels not launched: {launches}")
    del op_sa0, got

    x0 = op.init_guess(nroots)
    nb = x0.shape[0]
    torch.cuda.reset_peak_memory_stats()
    s = time.perf_counter()
    e, _, conv, info = davidson(op.matvec, op.hdiag, nroots=nroots, init_guess=x0,
                                tol=1e-3, max_space_factor=8, pick_positive=False,
                                device=op.device, dtype=op.dtype)
    _sync()
    wall = time.perf_counter() - s
    cycles = info["cycles"]
    flops = sf_matvec_flops(n_o, n_v, naux, ngrid, nb)
    rec = {**sig, "wall_s": wall, "cycles": cycles, "nb": nb, "nconv": int(conv.sum()),
           "nroots": nroots, "builds_per_s": cycles / wall,
           "tflops": flops * cycles / wall / 1e12, "flops_per_build": flops,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "e": e.tolist()}
    _log("phase 6 solve", json.dumps(rec))
    if not (conv.sum() == nroots and np.all(np.isfinite(e)) and np.all(np.diff(e) >= 0)):
        raise AssertionError(f"bench flip solve: {rec}")
    return rec


def _run_phases(record: dict, t_start: float, out: str | None = None) -> None:
    """Phases 0-8 into ``record``, in the order that lets the later ones
    reuse what the earlier built; the seconds since the start after each."""
    def done(name):
        _log(f"{name} done at {time.perf_counter() - t_start:.1f} s")

    record["card"] = phase0()
    record["builds_s"] = phase1()
    done("phase 1")
    record["kernels"] = phase2()
    done("phase 2")
    record["ttm"], ref = phase3()
    done("phase 3")
    record["ttm_flip"] = phase5(ref)
    done("phase 5")
    k3_ao = [c for c in record["kernels"]["checks"] if c["kernel"] == "grid_back"
             and c["shape"] == "ttm_ao" and c["dtype"] == "float64"][0]
    record["scf"] = phase7(ref.mf, record["ttm"]["e_ev"], k3_ao["ms"])
    done("phase 7")
    vectors = None if out is None else pathlib.Path(out).with_name(
        pathlib.Path(out).stem + "_dzp_vectors.npz")
    if vectors is not None:
        vectors.parent.mkdir(parents=True, exist_ok=True)
    phase8(ref, record.setdefault("dzp", {}), vectors)
    done("phase 8")
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    record["bench"], data = phase4()
    done("phase 4")
    record["bench_flip"] = phase6(data)
    done("phase 6")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    record = {}
    try:
        _run_phases(record, t_start, args.out)
    finally:
        if args.out:  # every number so far, also when a phase failed
            pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            pathlib.Path(args.out).write_text(json.dumps(record, indent=1))
    card = record["card"]

    from xtddft_tpu_torch import kernels

    entries = []
    for m in kernels.MODULES:
        # the main path's own shape: TTM, f64, alpha block; K2 and K3 on a jvp
        # group's span
        main_check = [c for c in record["kernels"]["checks"]
                      if c["kernel"] == m.NAME and c["shape"] == "ttm"
                      and c["dtype"] == "float64" and c.get("spin") == "a"][-1]
        # the flip mode that phase 5 runs (exchange-only, value-only), where
        # one library call computes the function
        flip_check = [c for c in record["kernels"]["checks"]
                      if c["kernel"] == m.NAME and c["shape"] == "ttm_down"
                      and c["dtype"] == "float64" and c.get("library_ms") is not None][-1]
        # the SCF's AO mode (phase 7's Fock build), f64
        ao_check = [c for c in record["kernels"]["checks"]
                    if c["kernel"] == m.NAME and c["shape"] == "ttm_ao"
                    and c["dtype"] == "float64" and c["mode"] in ("ao", "hermi")][0]
        # the production shapes, f64: the dzp X-TDA alpha block (K2 and K3 on
        # a jvp group's span) and the dzp SCF's AO mode
        dzp_check = [c for c in record["kernels"]["checks"]
                     if c["kernel"] == m.NAME and c["shape"] == "dzp" and c.get("spin") == "a"][-1]
        dzp_ao_check = [c for c in record["kernels"]["checks"]
                        if c["kernel"] == m.NAME and c["shape"] == "dzp_ao"
                        and c["mode"] in ("ao", "hermi")][0]
        dzp = record["dzp"]
        entries.append({
            "name": m.NAME, "route": m.ROUTE, "source": m.SOURCE, "replaces": m.REPLACES,
            "launches": record["ttm"]["launches"][m.NAME],
            "launches_flip": record["ttm_flip"]["launches"][m.NAME],
            **{k: main_check[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            **{f"flip_{k}": flip_check[k] for k in ("ms", "plain_ms", "bound_ms",
                                                    "library_ms")},
            "scf_replaces": SCF_REPLACES[m.NAME],
            "launches_scf": record["scf"]["launches"][m.NAME],
            "launches_scf_xtda": record["scf"]["xtda"]["launches"][m.NAME],
            **{f"scf_{k}": ao_check[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "library_ms")},
            # null where the kernel has no atomic order (K1)
            "scf_fixed_order_cost": ao_check.get("fixed_order_cost"),
            "fixed_order_cost": main_check.get("fixed_order_cost"),
            "launches_dzp_xtda": dzp["xtda"]["launches"][m.NAME],
            "launches_dzp_xsf": dzp["xsf"]["launches"][m.NAME],
            "launches_dzp_scf": dzp["scf"]["launches"][m.NAME],
            "launches_dzp_scf_xtda": dzp["scf_xtda"]["launches"][m.NAME],
            **{f"dzp_{k}": dzp_check[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                  "bound_by", "library_ms")},
            **{f"dzp_scf_{k}": dzp_ao_check[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                         "bound_ms", "bound_by", "library_ms")},
        })
    record["total_s"] = time.perf_counter() - t_start
    _log("total seconds", record["total_s"])
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(record, indent=1))
    print(card["nvidia_smi"])
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
