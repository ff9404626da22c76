"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, drive, report.

    python3 chip_smoke.py [--out PATH]

Phases (any failure raises; the script exits non-zero and prints no result):

0. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
   no CUDA device is a failure;
1. build the native integral engine and the CUDA kernels K1-K3 from the
   checkout's sources, with the seconds each build took;
2. each kernel against its plain torch version at the main path's shapes
   (TTM/STO-3G and the nmo=1000 bench operator; K3 also on the span of one
   jvp group), f64 and f32, with median CUDA-event times of both and the
   card's bound for the same work (``response/flops.py``); K1 also at its
   edge cases (nocc above 256, nvir below one tile, one trial vector);
3. the main path: X-TDA on the TTM radical (182 AO, ROKS/B3LYP, density
   fitted) through ``XTDA(load_mf(...), backend="df").kernel()`` in f64,
   gated against ``tests/data/golden_ttm.json``; every kernel must have
   launched in this run;
4. the bench-shape operator (nmo=1000, naux=2000, 49152 grid points, f32):
   one 20-vector sigma build against the plain path, then a 20-root solve.

The line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  ``--out`` also writes every number to a
JSON file.
"""

from __future__ import annotations

import argparse
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
TTM_GATE_EV = 5e-3  # the JAX DF path's own gate (tests/test_production.py)


def _log(*args):
    print(*args, flush=True)


def _sync():
    torch.cuda.synchronize()


def time_ms(fn, reps: int = 5) -> float:
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
    from xtddft_tpu_torch import kernels
    from xtddft_tpu_torch.buildlib import BUILD_SECONDS
    from xtddft_tpu_torch.ints import native

    native.load()
    kernels.build_all()
    _log("phase 1 builds (s):", json.dumps(BUILD_SECONDS))
    return dict(BUILD_SECONDS)


# (label, nz, naux, nmo, ((nocc, nvir) of the alpha and beta blocks), the
# grid chunks of one jvp group, the span K3 takes in one launch)
MAIN_SHAPES = (
    ("ttm", 10, 4412, 182, ((137, 45), (136, 46)), 23),
    ("bench", 20, 2000, 1000, ((80, 920), (78, 922)), 12),
)
# K1 edge cases, checked but not timed: (label, nz, naux, nmo, nocc, nvir)
K1_EDGES = (
    ("nocc300_odd_naux", 4, 257, 340, 300, 40),
    ("nvir_below_tile", 3, 100, 60, 50, 10),
    ("nz1", 1, 96, 120, 30, 90),
)


def _check(checks, rec, kern, plain, timed, flops=None, nbytes=None):
    """Hold kern() against plain() (relative to max |plain|); time both
    and add the bound when ``timed``."""
    got = kern()
    _sync()
    want = plain()
    _sync()
    rec["max_abs_err"], rec["rel_err"] = rel_err(got, want)
    del got, want
    if timed:
        from xtddft_tpu_torch.response.flops import bound_ms

        rec["ms"] = time_ms(kern)
        rec["plain_ms"] = time_ms(plain)  # the cuBLAS einsum route of the JAX code
        rec["bound_ms"], rec["bound_by"] = bound_ms(flops, nbytes, rec["dtype"])
        rec["library_ms"] = None  # no single PyTorch call computes the function
    _log("phase 2", json.dumps(rec))
    if not rec["rel_err"] <= rec["rtol"]:
        raise AssertionError(f"{rec['kernel']} disagrees with its plain version: {rec}")
    checks.append(rec)


def phase2() -> dict:
    """Each kernel against its plain version, f64 and f32, TTM and bench
    shapes, both spin blocks (times and bounds at the alpha block); K3 also
    on the span of one jvp group; K1 at its edge cases."""
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
        for label, nz, naux, nmo, blocks, nspan in MAIN_SHAPES:
            G = torch.randn((naux, nmo, 8), generator=g, device="cuda", dtype=dtype)
            B = torch.bmm(G, G.transpose(1, 2)) / (naux * nmo * 8) ** 0.5
            del G
            span = nspan * gc
            # grid points as the sigma sees them: strided views of a padded table
            phi_all = torch.randn((4, gc + span, nmo), generator=g, device="cuda",
                                  dtype=dtype) / nmo ** 0.5
            phi = phi_all[:, gc:2 * gc]
            phi_span = phi_all[:, gc:gc + span]
            mask = (torch.rand(gc, generator=g, device="cuda") > 0.05).to(dtype)
            for spin, (no, nv) in zip("ab", blocks):
                z = torch.randn((nz, no, nv), generator=g, device="cuda", dtype=dtype)
                dwv = torch.randn((nz, span), generator=g, device="cuda", dtype=dtype)
                dwg = torch.randn((nz, 3, span), generator=g, device="cuda", dtype=dtype)
                out = torch.zeros((nz, no, nv), device="cuda", dtype=dtype)
                timed = spin == "a"

                def rec(name, **kw):
                    return {"kernel": name, "shape": label, "spin": spin, "dtype": dname,
                            "nz": nz, "naux": naux, "nmo": nmo, "nocc": no, "nvir": nv,
                            "rtol": tol, **kw}

                _check(checks, rec(k1.NAME),
                       lambda: torch.cat([x.flatten() for x in k1.df_exchange(B, z, 0, no)]),
                       lambda: torch.cat([x.flatten() for x in
                                          k1.df_exchange_plain(B, z, 0, no)]),
                       timed, fl.df_exchange_flops(naux, nz, no, nv),
                       fl.df_exchange_bytes(naux, nz, no, nv, isz))
                _check(checks, rec(k2.NAME, gc=gc),
                       lambda: k2.grid_rho1(phi, z, 0, no, mask),
                       lambda: k2.grid_rho1_plain(phi, z, 0, no, mask),
                       timed, fl.grid_rho1_flops(nz, no, nv, gc),
                       fl.grid_rho1_bytes(nz, no, nv, gc, isz))
                one_chunk = (gc, phi, dwv[:, :gc].contiguous(), dwg[..., :gc].contiguous())
                for pts, ph, dv, dg in (one_chunk, (span, phi_span, dwv, dwg)):
                    _check(checks, rec(k3.NAME, gc=pts),
                           lambda: k3.grid_back(dv, dg, ph, 0, no, out.zero_()).clone(),
                           lambda: k3.grid_back_plain(dv, dg, ph, 0, no, out.zero_()).clone(),
                           timed, fl.grid_back_flops(nz, no, nv, pts),
                           fl.grid_back_bytes(nz, no, nv, pts, isz))
            del B, phi_all, phi, phi_span
            torch.cuda.empty_cache()
        for label, nz, naux, nmo, no, nv in K1_EDGES:
            B = torch.randn((naux, nmo, nmo), generator=g, device="cuda", dtype=dtype)
            z = torch.randn((nz, no, nv), generator=g, device="cuda", dtype=dtype)
            # o and v blocks at offsets, as the beta block of a sigma reads them
            o0, v0 = nmo - no - nv, nmo - nv
            _check(checks, {"kernel": k1.NAME, "shape": label, "spin": "a", "dtype": dname,
                            "nz": nz, "naux": naux, "nmo": nmo, "nocc": no, "nvir": nv,
                            "rtol": tol},
                   lambda: torch.cat([x.flatten() for x in k1.df_exchange(B, z, o0, v0)]),
                   lambda: torch.cat([x.flatten() for x in k1.df_exchange_plain(B, z, o0, v0)]),
                   False)
    return {"checks": checks}


def _first_fxc_jvp():
    """The first torch.func transform of a process loads its decompositions
    and imports (~10 s); pay that in the set-up, not in the timed solve."""
    from xtddft_tpu_torch.xc import interface, registry

    respond = interface.make_fxc_jvp(registry.resolve("b3lyp"))
    r = torch.ones(8, device="cuda", dtype=torch.float64)
    g = torch.zeros((3, 8), device="cuda", dtype=torch.float64)
    torch.func.vmap(lambda d: respond(r, (r, r, g, g), d))((r[None], r[None], g[None], g[None]))


def phase3() -> dict:
    """The main path: TTM X-TDA, f64, through the public entry point."""
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
    return rec


def phase4() -> dict:
    """Bench-shape synthetic operator, f32: sigma check and 20-root solve."""
    from xtddft_tpu_torch.kernels import df_exchange as k1
    from xtddft_tpu_torch.kernels import grid_back as k3
    from xtddft_tpu_torch.kernels import grid_rho1 as k2
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
    # the plain path: the same operator with each kernel's plain version
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
    err, rel = rel_err(got, want)
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
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    args = ap.parse_args(argv)

    card = phase0()
    record = {"card": card, "builds_s": phase1(), "kernels": phase2()}
    record["ttm"] = phase3()
    record["bench"] = phase4()

    from xtddft_tpu_torch import kernels

    entries = []
    for m in kernels.MODULES:
        # the main path's own shape: TTM, f64, alpha block; K3 on a jvp group's span
        main_check = [c for c in record["kernels"]["checks"]
                      if c["kernel"] == m.NAME and c["shape"] == "ttm"
                      and c["dtype"] == "float64" and c["spin"] == "a"][-1]
        entries.append({
            "name": m.NAME, "route": m.ROUTE, "source": m.SOURCE, "replaces": m.REPLACES,
            "launches": record["ttm"]["launches"][m.NAME],
            **{k: main_check[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
        })
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(record, indent=1))
    print(card["nvidia_smi"])
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
