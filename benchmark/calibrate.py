"""Readings that a cell's limits are set from, on the card, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--out chiprun_out/calib.jsonl]

For each of ``--seeds`` the program runs as a run of the cell does (one
warm solve, then as many solves as a run compares) and the check's numbers
are read against the reference.  For each of ``--control-seeds`` the
control runs in the program's place: the reference itself, its products in
the precision below the configuration's (TF32 products for an f32 cell,
f32 for an f64 cell), through the reference's Davidson at the traffic's
tolerance; its numbers are read the same way.  One JSON line per seed, on
standard output and appended to ``--out``.
"""

import argparse
import contextlib
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))


def _seeds(s: str):
    return [int(x) for x in s.split(",") if x]


def _reading(c, kind: str, seed: int, control_dtype, tf32: bool) -> dict:
    """One seed's readings of the program (as a run of the cell makes
    them) or of the control."""
    import torch

    from xbench import cell as xcell
    from xbench import check
    from xbench.inputs import make_inputs

    t0 = time.perf_counter()
    inp = make_inputs(c.cfg, seed, "cuda")
    if kind == "program":
        port = xcell.Port(inp)
        off = lambda _: contextlib.nullcontext()  # noqa: E731
        xcell.Solves(seed, 0, False, off).run(port, c.traffic)
        solves = xcell.Solves(seed, c.limits["solves_compared"], False, off)
        for _ in range(c.limits["solves_compared"]):
            solves.run(port, c.traffic)
        samples = solves.samples
        conv = all(r["converged"] for r in solves.records)
        builds = [len(r["builds"]) for r in solves.records]
        del port
    else:
        s = check.control_sample(inp, c.traffic, control_dtype, tf32)
        samples, conv, builds = [s], s["converged"], [len(s["builds"])]
    t1 = time.perf_counter()
    values = check.readings(inp, c.traffic, samples, c.limits["ref_tol"])
    rec = {"kind": kind, "seed": seed, **values, "converged": conv, "builds": builds,
           "run_s": t1 - t0, "check_s": time.perf_counter() - t1,
           "roots": [float(x) for x in samples[0]["e"]]}
    del inp, samples
    torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)

    import torch

    from xbench import cell as xcell

    c = xcell.load_cell(a.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    from xtddft_tpu_torch import config

    config.initialize()
    control_dtype = torch.float32
    tf32 = c.cfg["dtype"] == "float32"
    with open(a.out, "a") if a.out else contextlib.nullcontext() as out:
        for kind, seeds in (("program", _seeds(a.seeds)), ("control", _seeds(a.control_seeds))):
            for seed in seeds:
                rec = _reading(c, kind, seed, control_dtype, tf32)
                line = json.dumps({"workload": a.workload, **rec})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
