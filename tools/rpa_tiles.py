"""Time K1's RPA exchange mode at the shapes of `chip_smoke.py` phase 2 for
each choice of the two GEMMs' row tiles, beside its plain version, its
library einsum and its bound.

Needs one CUDA card.  Prints one JSON line per shape and dtype (kernel ms
per tile pair, plain, library and bound ms, the relative error against the
plain version, whether the default choice repeats bitwise), then the card's
name and power limit:

    python3 tools/rpa_tiles.py [--shapes ttm,bench,dzp] [--reps 3]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from xtddft_tpu_torch.buildlib import BUILD_LOGS, BUILD_SECONDS  # noqa: E402
from xtddft_tpu_torch.kernels import _cuda  # noqa: E402
from xtddft_tpu_torch.kernels import df_exchange as k1  # noqa: E402
from xtddft_tpu_torch.response import flops as fl  # noqa: E402

# (label, naux, nmo, nocc, nvir, dtypes): phase 2's RPA blocks, nz 20
SHAPES = {
    "ttm": (4412, 182, 137, 45, (torch.float64, torch.float32)),
    "bench": (2000, 1000, 80, 920, (torch.float64, torch.float32)),
    "dzp": (3990, 598, 137, 461, (torch.float64,)),
}
NZ = 20
TILES = ((0, 0), (64, 64), (64, 128), (128, 64), (128, 128))


def time_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return sorted(out)[len(out) // 2]


def profile(fn) -> dict:
    """Device milliseconds of one call by kernel name (the GEMM kernels by
    their epilogue: HalfStore is stage A, BackStore stage B)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof

    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in p.key_averages():
        t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0.0)
        if t:
            name = e.key
            for tag in ("HalfStore", "BackStore", "sum_slices"):
                if tag in name:
                    name = tag
            out[name[:60]] = out.get(name[:60], 0.0) + t / 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--profile", action="store_true",
                    help="also the device time of each kernel of one default call "
                         "(torch.profiler)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("rpa_tiles: no CUDA device")
    _cuda.load(k1.NAME, k1._ARGS)
    print(json.dumps({"build_s": BUILD_SECONDS}), flush=True)
    log = BUILD_LOGS.get(k1.NAME, "")
    print("\n".join(ln for ln in log.splitlines() if "tma_gemm" in ln or "Used" in ln
                    or "spill" in ln)[-6000:], flush=True)
    g = torch.Generator("cuda").manual_seed(1234)
    for label in args.shapes.split(","):
        naux, nmo, no, nv, dtypes = SHAPES[label]
        for dtype in dtypes:
            G = torch.randn((naux, nmo, 8), generator=g, device="cuda", dtype=dtype)
            B = torch.bmm(G, G.transpose(1, 2)) / (naux * nmo * 8) ** 0.5
            del G
            z = torch.randn((NZ, no, nv), generator=g, device="cuda", dtype=dtype)
            R = k1.rpa_aligned(B, 0, no, no, nv)
            want = k1.rpa_exchange_plain(B, z, 0, no)
            rec = {"shape": label, "dtype": str(dtype).split(".")[-1], "naux": naux,
                   "nocc": no, "nvir": nv, "nz": NZ,
                   "order": "ov" if k1.rpa_order(no, nv) == k1.RPA_OV else "vo"}
            got = k1.rpa_exchange(B, z, 0, no, aligned=R)
            rec["rel_err"] = float((got - want).abs().max() / want.abs().max())
            rec["repeats_bitwise"] = bool(torch.equal(got, k1.rpa_exchange(B, z, 0, no,
                                                                           aligned=R)))
            del got
            for tiles in TILES:
                rec[f"ms_{tiles[0]}_{tiles[1]}"] = time_ms(
                    lambda: k1.rpa_exchange(B, z, 0, no, aligned=R, tiles=tiles), args.reps)
            rec["plain_ms"] = time_ms(lambda: k1.rpa_exchange_plain(B, z, 0, no), args.reps)
            Bov = B[:, :no, no:no + nv]
            spec = ("xjb,Pib,Pja->xia" if k1.rpa_order(no, nv) == k1.RPA_OV
                    else "xjb,Pja,Pib->xia")
            rec["library_ms"] = time_ms(lambda: torch.einsum(spec, z, Bov, Bov), args.reps)
            if args.profile:
                rec["kernels_ms"] = profile(lambda: k1.rpa_exchange(B, z, 0, no, aligned=R))
            rec["bound_ms"], rec["bound_by"] = fl.bound_ms(
                fl.rpa_exchange_flops(naux, NZ, no, nv),
                fl.rpa_exchange_bytes(naux, NZ, no, nv, B.element_size()), rec["dtype"])
            print(json.dumps(rec), flush=True)
            del B, z, R, want, Bov
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
