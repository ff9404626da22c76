"""Where a DF X-TDA sigma build of the PyTorch port spends its time, on a GPU.

    python3 tools/torch_sigma_profile.py [--ttm] [--bench] [--xtda] [--out DIR]

Builds the operator (TTM/STO-3G from ``tests/data/ttm_ckpt.npz`` in f64,
and/or the nmo=1000 bench operator in f32), times a few sigma builds of the
main path's block size with the host clock around ``torch.cuda.synchronize``,
then profiles one build with ``torch.profiler`` and prints the device time
by kernel and the summed kernel time of that build (one stream, so the
kernels do not overlap).  ``--out`` writes the
chrome traces there.  ``--xtda`` instead runs the whole TTM
``XTDA(...).kernel()`` under cProfile and prints the host functions with the
most cumulative time.
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


def _ttm_op():
    from xtddft_tpu_torch.response.reference_state import make_reference
    from xtddft_tpu_torch.response.sigma_df import build_df_data, xtda_sigma_df
    from xtddft_tpu_torch.scf.checkpoint import load_mf

    mf = load_mf(str(ROOT / "tests/data/ttm_ckpt.npz"), df=True, device="cuda",
                 dtype=torch.float64)
    op = xtda_sigma_df(build_df_data(make_reference(mf)))
    return op, op.init_guess(10).shape[0]


def _bench_op():
    from xtddft_tpu_torch.response.sigma_df import synthetic_df_data, xtda_sigma_df

    g = torch.Generator("cuda").manual_seed(0)
    op = xtda_sigma_df(synthetic_df_data(generator=g, device="cuda", dtype=torch.float32))
    return op, op.init_guess(20).shape[0]


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ttm", action="store_true")
    ap.add_argument("--bench", action="store_true")
    ap.add_argument("--xtda", action="store_true")
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("torch_sigma_profile: needs a CUDA device")
    if args.xtda:
        xtda_host_profile(args.out)
        return 0
    if args.ttm or not args.bench:
        profile("ttm", *_ttm_op(), args.out)
    if args.bench or not args.ttm:
        profile("bench", *_bench_op(), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
