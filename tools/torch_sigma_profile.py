"""Where a DF sigma build of the PyTorch port spends its time, on a GPU.

    python3 tools/torch_sigma_profile.py [--op xtda|xsf] [--ttm] [--bench] [--xtda] [--out DIR]
    python3 tools/torch_sigma_profile.py --solve N --against DIR

Builds the operator (TTM/STO-3G from ``tests/data/ttm_ckpt.npz`` in f64,
and/or the nmo=1000 bench operator in f32; ``--op xtda``, the default, the
spin-conserving X-TDA sigma, ``--op xsf`` the spin-flip XSF-TDA sigma: SA=0
on the TTM doublet, SA=3 at the bench width), times a few sigma builds of the
main path's block size with the host clock around ``torch.cuda.synchronize``,
then profiles one build with ``torch.profiler`` and prints the device time
by kernel and the summed kernel time of that build (one stream, so the
kernels do not overlap).  ``--out`` writes the
chrome traces there.  ``--xtda`` instead runs the whole TTM
``XTDA(...).kernel()`` under cProfile and prints the host functions with the
most cumulative time.  ``--solve N --against DIR`` instead compares the
steady-state TTM X-TDA solve of this tree with that of another checkout
(DIR, for example the parent commit unpacked by ``git archive``): four
processes in the order DIR, this tree, this tree, DIR, each timing N
solves after its host set-up and a first solve (kernel builds and first
uses out of the way).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _make_op(data, which: str, SA: int):
    from xtddft_tpu_torch.response.sigma_df import xsf_sigma_df, xtda_sigma_df

    if which == "xsf":
        return xsf_sigma_df(data, SA=SA, remove=True, method=0)
    return xtda_sigma_df(data)


def _ttm_op(which: str):
    from xtddft_tpu_torch.response.reference_state import make_reference
    from xtddft_tpu_torch.response.sigma_df import build_df_data
    from xtddft_tpu_torch.scf.checkpoint import load_mf

    mf = load_mf(str(ROOT / "tests/data/ttm_ckpt.npz"), df=True, device="cuda",
                 dtype=torch.float64)
    op = _make_op(build_df_data(make_reference(mf)), which, SA=0)
    return op, op.init_guess(10).shape[0]


def _bench_op(which: str):
    from xtddft_tpu_torch.response.sigma_df import synthetic_df_data

    g = torch.Generator("cuda").manual_seed(0)
    op = _make_op(synthetic_df_data(generator=g, device="cuda", dtype=torch.float32),
                  which, SA=3)
    return op, op.init_guess(10 if which == "xsf" else 20).shape[0]


def profile(label: str, op, nb: int, out: pathlib.Path | None) -> dict:
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    g = torch.Generator("cuda").manual_seed(1)
    z = torch.randn((nb, op.dim), generator=g, device="cuda", dtype=op.dtype)
    op.matvec(z)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        op.matvec(z)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        op.matvec(z)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side entries only: a host op (aten::bmm) also carries the
    # device time of the kernels it launched, which are listed themselves
    kernels = sorted((e for e in prof.key_averages()
                      if getattr(e.device_type, "name", "") == "CUDA"),
                     key=lambda e: -e.self_device_time_total)
    busy_us = sum(e.self_device_time_total for e in kernels)
    rows = [{"name": e.key[:60], "calls": e.count,
             "device_ms": e.self_device_time_total / 1e3} for e in kernels[:15]]
    rec = {"shape": label, "nb": nb, "wall_s": walls, "profiled_wall_s": wall,
           "device_busy_ms": busy_us / 1e3, "top": rows}
    print(json.dumps(rec), flush=True)
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / f"sigma_{label}.json"))
    return rec


def xtda_host_profile(out: pathlib.Path | None) -> None:
    """cProfile of the TTM X-TDA driver after the host set-up."""
    import cProfile
    import pstats

    from xtddft_tpu_torch.methods.drivers import XTDA
    from xtddft_tpu_torch.response.reference_state import make_reference
    from xtddft_tpu_torch.scf.checkpoint import load_mf

    mf = load_mf(str(ROOT / "tests/data/ttm_ckpt.npz"), df=True, device="cuda",
                 dtype=torch.float64)
    ref = make_reference(mf)
    mf.env.ao
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    res = XTDA(ref, nstates=10, backend="df").kernel()
    torch.cuda.synchronize()
    prof.disable()
    print(json.dumps({"xtda_wall_s": time.perf_counter() - t0, "cycles": res.cycles}))
    stats = pstats.Stats(prof).sort_stats("cumulative")
    stats.print_stats(30)
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        stats.dump_stats(str(out / "xtda_ttm.pstats"))


def xtda_solves(n: int) -> None:
    """Wall seconds of n steady-state TTM X-TDA solves, one JSON line."""
    import xtddft_tpu_torch
    from xtddft_tpu_torch.methods.drivers import XTDA
    from xtddft_tpu_torch.response.reference_state import make_reference
    from xtddft_tpu_torch.scf.checkpoint import load_mf

    mf = load_mf(str(ROOT / "tests/data/ttm_ckpt.npz"), df=True, device="cuda",
                 dtype=torch.float64)
    ref = make_reference(mf)
    mf.env.ao
    walls = []
    for _ in range(n + 1):
        t0 = time.perf_counter()
        res = XTDA(ref, nstates=10, backend="df").kernel()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(json.dumps({"package": xtddft_tpu_torch.__file__, "xtda_solve_s": walls[1:],
                      "first_solve_s": walls[0], "cycles": res.cycles}), flush=True)


def solve_pairs(n: int, against: pathlib.Path) -> None:
    """xtda_solves of ``against`` and of this tree in alternating
    processes (against, this, this, against); one JSON line each, then the
    two trees' solve times side by side."""
    import subprocess

    times = {"against": [], "this": []}
    for tag, root in (("against", against), ("this", ROOT), ("this", ROOT),
                      ("against", against)):
        run = subprocess.run([sys.executable, __file__, "--solve", str(n), "--root", str(root)],
                             cwd=root, capture_output=True, text=True)
        if run.returncode != 0:
            sys.stderr.write(run.stderr[-4000:])
            raise SystemExit(f"torch_sigma_profile: the solves in {root} failed")
        rec = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": tag, **rec}), flush=True)
        times[tag].append(rec["xtda_solve_s"])
    print(json.dumps({"against_s": times["against"], "this_s": times["this"]}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--op", choices=("xtda", "xsf"), default="xtda")
    ap.add_argument("--ttm", action="store_true")
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--xtda", action="store_true")
    ap.add_argument("--solve", type=int, default=0, metavar="N")
    ap.add_argument("--against", type=pathlib.Path, metavar="DIR")
    ap.add_argument("--root", type=pathlib.Path, help=argparse.SUPPRESS)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_sigma_profile: needs a CUDA device")
    if args.solve and args.against:
        solve_pairs(args.solve, args.against.resolve())
        return 0
    if args.xtda:
        xtda_host_profile(args.out)
        return 0
    if args.solve:
        if args.root is None:
            raise SystemExit("torch_sigma_profile: --solve needs --against DIR")
        sys.path.insert(0, str(args.root))  # the package of the tree under test
        xtda_solves(args.solve)
        return 0
    if args.ttm or not args.bench:
        profile(f"ttm_{args.op}", *_ttm_op(args.op), args.out)
    if args.bench or not args.ttm:
        profile(f"bench_{args.op}", *_bench_op(args.op), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
