"""The fixed summation order's cost for K2 and K3 on the response shapes.

K1 sums in its fixed order on every path.  K2 (`grid_rho1`) and K3
(`grid_back`) take ``fixed_order=`` and the SCF passes it; the sigma runs
them in their atomic order.  This script times both orders of K2 and K3 on
the X-TDA shapes of `chip_smoke.py` phase 2 (TTM and the bench width, f64 and
f32; TTM/dzp, f64; one 4096-point chunk and one jvp group's span, alpha
block), in interleaved rounds (atomic, fixed, then fixed, atomic, ...), each
a median of CUDA-event times, and prints per case the fixed order's time
over the atomic one's, less one: the median over the rounds and its range.

Run:  python3 tools/fixed_order_cost.py [--rounds N]   (one CUDA card)
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=8)
    args = ap.parse_args()

    from chip_smoke import MAIN_SHAPES, time_ms
    from xtddft_tpu_torch import kernels
    from xtddft_tpu_torch.kernels import grid_back as k3
    from xtddft_tpu_torch.kernels import grid_rho1 as k2

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    kernels.build_all()
    g = torch.Generator("cuda").manual_seed(1234)
    gc = 4096
    rows = []
    for label, nz, naux, nmo, blocks, nspan, dtypes in MAIN_SHAPES:
        no, nv = blocks[0]
        for dtype in dtypes:
            span = nspan * gc
            phi = torch.randn((4, span, nmo), generator=g, device="cuda", dtype=dtype) / nmo ** 0.5
            mask = (torch.rand(span, generator=g, device="cuda") > 0.05).to(dtype)
            z = torch.randn((nz, no, nv), generator=g, device="cuda", dtype=dtype)
            dwv = torch.randn((nz, span), generator=g, device="cuda", dtype=dtype)
            dwg = torch.randn((nz, 3, span), generator=g, device="cuda", dtype=dtype)
            out = torch.zeros((nz, no, nv), device="cuda", dtype=dtype)
            for pts in (gc, span):
                ph, mk = phi[:, :pts], mask[:pts]
                dv, dg = dwv[:, :pts].contiguous(), dwg[..., :pts].contiguous()
                cases = {
                    k2.NAME: lambda f: k2.grid_rho1(ph, z, 0, no, mk, fixed_order=f),
                    k3.NAME: lambda f: k3.grid_back(dv, dg, ph, 0, no, out.zero_(), fixed_order=f),
                }
                for name, run in cases.items():
                    costs, ms = [], {False: [], True: []}
                    for r in range(args.rounds):
                        order = (False, True) if r % 2 == 0 else (True, False)
                        t = {f: time_ms(lambda: run(f), reps=5) for f in order}
                        for f in order:
                            ms[f].append(t[f])
                        costs.append(t[True] / t[False] - 1.0)
                    row = {"kernel": name, "shape": label, "dtype": str(dtype).split(".")[-1],
                           "gc": pts, "atomic_ms": statistics.median(ms[False]),
                           "fixed_ms": statistics.median(ms[True]),
                           "cost_median": statistics.median(costs), "cost_min": min(costs),
                           "cost_max": max(costs), "rounds": args.rounds}
                    rows.append(row)
                    print(json.dumps(row), flush=True)
            del phi, mask, z, dwv, dwg, out
            torch.cuda.empty_cache()
    for name in (k2.NAME, k3.NAME):
        worst = max(r["cost_median"] for r in rows if r["kernel"] == name)
        print(json.dumps({"kernel": name, "worst_median_cost": worst}), flush=True)


if __name__ == "__main__":
    main()
