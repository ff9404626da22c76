"""The benchmark of xtddft_tpu_torch: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the numbers compared with the reference on standard error, then one
JSON line on standard output (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` a ``breakdown``; the solves'
seconds and builds, the set-up's stages and the card's state; and last the
``check``: each compared number beside its limit).  Exits non-zero without
a result when there is no CUDA card, or fewer than the cell asks for.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))
os.environ.setdefault("USE_FLAX", "0")
# one process with few threads: the host only dispatches to the card and
# solves the Davidson's small pencil, and idle pool threads that spin
# beside the dispatching thread make the runs spread
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    from xbench import cell as xcell

    c = xcell.load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{a.workload} needs {c.chips} CUDA card(s); found {n}", file=sys.stderr)
        return 2
    from xtddft_tpu_torch import config

    config.initialize()
    xcell.run(c, a.seed, a.seconds, bool(a.trace), "cuda", T_START)
    return 0


if __name__ == "__main__":
    sys.exit(main())
