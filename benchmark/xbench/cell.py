"""One run of a cell: set-up, the measured window, the check, the result.

Everything a cell is made of is found by name: its entry in the root's
``BENCHMARK.json`` names a configuration (a file of sizes under
``configs/``) and a traffic mix (``traffic/<name>.json``); its limits are
``limits/<cell>.json``; each per-layer metric is read by
``metrics/<metric>.py``.  The program under test is the port,
``xtddft_tpu_torch``: the operator constructors of
``response/sigma_df.py`` and the block Davidson of ``solver/davidson.py``,
on the hand-written kernels K1-K3.

A solve is what a user's ``XTDA(...)`` / ``XSFTDA(...)`` call does after
``build_df_data``: the operator from the DFData (its diagonal, guess and,
for SA > 0, the dA tensors), then the Davidson until every root converges.
The window runs solves back to back, a closed loop of one client, and ends
with the first solve that finishes after ``seconds``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from xbench import check, counts
from xbench.inputs import make_inputs

HERE = pathlib.Path(__file__).resolve().parents[1]
REPO = HERE.parent
# solves traced after the window of a --trace 1 run
TRACED_SOLVES = 3
# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "xtddft_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_path: pathlib.Path = REPO / "BENCHMARK.json") -> Cell:
    bench = json.loads(bench_path.read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in {bench_path}")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=name, chips=entry["chips"],
        cfg=json.loads((REPO / conf["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text()),
        limits=json.loads((HERE / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def shapes(cell: Cell) -> counts.Shapes:
    c = cell.cfg
    return counts.Shapes(method=cell.traffic["method"], nc=c["nc"], no=c["no"], nv=c["nv"],
                         naux=c["naux"], ngrid=c["ngrid"], dtype=c["dtype"])


class Port:
    """The program under test: its DFData from the cell's inputs, its
    operator for the traffic, its Davidson."""

    def __init__(self, inp):
        from xtddft_tpu_torch.response.sigma_df import DFData
        from xtddft_tpu_torch.xc import registry

        spec = registry.resolve(inp.xc)
        self.data = DFData(nc=inp.nc, no=inp.no, nv=inp.nv, B=inp.B, fock_mo=inp.fock_mo,
                           hyb=spec.hyb, spec=spec, phi=inp.phi, grid_w=inp.grid_w,
                           rho0=inp.rho0, fock_hf_mo=inp.fock_hf_mo)

    def operator(self, traffic: dict):
        from xtddft_tpu_torch.response import sigma_df

        if traffic["method"] == "xtda":
            return sigma_df.xtda_sigma_df(self.data)
        d = traffic["d_lda"]
        return sigma_df.xsf_sigma_df(self.data, SA=traffic["SA"], method=traffic["kernel"],
                                     remove=traffic["remove"],
                                     fglobal=(1.0 - d) * self.data.hyb + d)

    @staticmethod
    def load_kernels():
        """Load (on a checkout's first run, build) the libraries of K1-K3."""
        from concurrent.futures import ThreadPoolExecutor

        from xtddft_tpu_torch import kernels
        from xtddft_tpu_torch.kernels import _cuda

        with ThreadPoolExecutor(len(kernels.DF_MODULES)) as pool:
            for f in [pool.submit(_cuda.load, m.NAME, m._ARGS) for m in kernels.DF_MODULES]:
                f.result()

    @staticmethod
    def solve(op, matvec, traffic: dict, x0):
        from xtddft_tpu_torch.solver.davidson import davidson

        return davidson(matvec, op.hdiag, nroots=traffic["nroots"], init_guess=x0,
                        tol=traffic["tol"], max_space_factor=traffic["max_space_factor"],
                        pick_positive=traffic["pick_positive"], device=op.device,
                        dtype=op.dtype)


class Solves:
    """The window's record: per solve the operator's and the Davidson's
    seconds, each build's seconds and vector count (timed runs only), the
    convergence; and a sample of whole solves (every build's vectors and
    results, the roots and vectors) drawn from the seed as the window goes
    (reservoir sampling), for the check."""

    def __init__(self, seed: int, keep: int, timed: bool, annotate):
        self.rng = np.random.default_rng(seed)
        self.keep, self.timed, self.annotate = keep, timed, annotate
        self.records, self.samples = [], []
        self._builds, self._caps = [], []

    def _sync(self):
        if self.timed and torch.cuda.is_available():
            torch.cuda.synchronize()

    def wrap(self, matvec):
        def build(z):
            self._sync()
            t0 = time.perf_counter()
            with self.annotate("bench.sigma"):
                out = matvec(z)
            self._sync()
            self._builds.append((time.perf_counter() - t0, int(z.shape[0])))
            self._caps.append((z.detach().clone(), out.detach().clone()))
            return out
        return build

    def run(self, port: Port, traffic: dict):
        self._builds, self._caps = [], []
        with self.annotate("bench.solve"):
            t0 = time.perf_counter()
            with self.annotate("bench.operator"):
                op = port.operator(traffic)
                x0 = op.init_guess(traffic["nroots"])
                self._sync()
            t1 = time.perf_counter()
            with self.annotate("bench.davidson"):
                e, v, conv, _ = port.solve(op, self.wrap(op.matvec), traffic, x0)
            t2 = time.perf_counter()
        i = len(self.records)
        self.records.append({"operator_s": t1 - t0, "davidson_s": t2 - t1,
                             "builds": self._builds, "converged": bool(np.all(conv))})
        sample = {"builds": self._caps, "e": e, "x": np.ascontiguousarray(v.T)}
        if i < self.keep:
            self.samples.append(sample)
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.keep:
                self.samples[j] = sample
        self._caps = []


def load_metric(name: str):
    spec = importlib.util.spec_from_file_location(f"metric_{name.replace('.', '_')}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Context:
    """What a per-layer metric reads: the cell's shapes, the window's
    record (host clock, no profiler), the record of the traced solves that
    follow it, and their device trace."""
    shapes: counts.Shapes
    records: list
    traced: list
    trace: object

    @property
    def builds(self):
        return [b for r in self.records for b in r["builds"]]

    @property
    def traced_builds(self):
        return [b for r in self.traced for b in r["builds"]]


def nvidia_smi(fields: str) -> str | None:
    """``nvidia-smi``'s reading of ``fields`` on the first card, or None."""
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader",
                            "-i", "0"], capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip() if r.returncode == 0 else None


# the card's clocks, power, temperature and throttle reasons, read before and
# after the window: what a slow run's card was doing
CARD_STATE = ("clocks.sm,clocks.mem,power.draw,temperature.gpu,"
              "clocks_throttle_reasons.active")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        port_cls=Port, out=sys.stdout, err=sys.stderr) -> dict:
    """Set up, warm, measure, check; print the result line and return it."""
    from xbench import trace as tr

    on_card = torch.device(device).type == "cuda"
    stages = {}

    def stage(name, t0):
        if on_card:
            torch.cuda.synchronize()
        t = time.perf_counter()
        stages[name] = t - t0
        return t

    t = stage("imports", t_start)
    if on_card:
        port_cls.load_kernels()
    t = stage("kernels", t)
    inp = make_inputs(cell.cfg, seed, device)
    t = stage("inputs", t)
    port = port_cls(inp)
    t = stage("port", t)
    off = lambda _: contextlib.nullcontext()  # noqa: E731
    warm = Solves(seed, 0, False, off)
    warm.run(port, cell.traffic)
    t = stage("warm_solve", t)
    setup_s = t - t_start
    card = {"before": nvidia_smi(CARD_STATE)} if on_card else {}

    # the window; a traced run times each build (synchronised) in it
    solves = Solves(seed, cell.limits["solves_compared"], trace, off)
    w0 = time.perf_counter()
    while True:
        solves.run(port, cell.traffic)
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    if on_card:
        card["after"] = nvidia_smi(CARD_STATE)
    # a traced run then traces a few more solves: the profiler slows the
    # host's dispatch, so host-clock metrics come from the window above
    traced, device_trace = None, None
    if trace:
        traced = Solves(seed, 0, True, torch.profiler.record_function)
        prof = tr.profiler() if on_card else None
        with prof if prof is not None else contextlib.nullcontext():
            for _ in range(TRACED_SOLVES):
                traced.run(port, cell.traffic)
        device_trace = tr.read(prof) if prof is not None else None
        del prof
    done = solves.records + (traced.records if traced else [])
    attempted = len(done)
    failed = sum(not r["converged"] for r in done)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    del port, warm

    t_check = time.perf_counter()
    values = check.readings(inp, cell.traffic, solves.samples, cell.limits["ref_tol"])
    correct, lines = check.judge(values, cell.limits, failed)
    print(f"check took {time.perf_counter() - t_check:.3f} s", file=err)

    if trace:
        ctx = Context(shapes(cell), solves.records, traced.records, device_trace)
        metrics = {}
        for m in cell.per_layer:
            v = load_metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        e2e = {"solve_s": window_s / len(solves.records), "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if on_card:
        dev["power_limit"] = nvidia_smi("name,power.limit")
    result = {"correct": bool(correct), "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if device_trace is not None:
        dev.update(busy_s=device_trace.busy_s, window_s=device_trace.window_s)
        result["breakdown"] = {"device_ops": device_trace.device_ops,
                               "idle_gaps": device_trace.idle_gaps}
    result["solve_seconds"] = [r["operator_s"] + r["davidson_s"] for r in solves.records]
    result["builds"] = [len(r["builds"]) for r in solves.records]
    result["setup_stages"] = stages
    result["card"] = card
    result["check"] = {k: {"value": values[k], "limit": cell.limits[k]["limit"]}
                       for k in check.compared(cell.limits)}
    result["check"]["failed_solves"] = {"value": failed, "limit": 0}
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"forbidden modules loaded: {bad}")
    for line in lines:
        print(line, file=err)
    print(json.dumps(result), file=out, flush=True)
    return result
