"""Every cell of the benchmark cut to a size that the CPU runs in seconds."""

import atexit
import functools
import hashlib
import json
import os
import pathlib
import tempfile

import numpy as np

BENCH = pathlib.Path(__file__).resolve().parents[1]
# every cell at a size the CPU runs in seconds: its configuration's kind of
# inputs and its traffic mix, at nmo 31 (the open shells as the cell's)
TINY = {"nc": 6, "nv": 24, "naux": 40, "ngrid": 700}
# every cell of BENCHMARK.json: (configuration, traffic)
_BENCH = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
_FILES = {c["name"]: c["file"] for c in _BENCH["configs"]}
CELLS = {w["name"]: (_FILES[w["config"]], w["traffic"]) for w in _BENCH["workloads"]}
# the XSF-TDA flip path, which no cell runs yet (PERF.md, open question 1):
# its traffic as a later cell would give it, rehearsed on the first cell's
# configuration so that the harness's flip path stays sound, with the
# limits that PERF.md records for an f32 flip cell (the f32 ALDA0 kernel's
# gap near ra = rb sets sigma_err there)
FLIP = {"method": "xsf", "SA": 0, "kernel": 0, "remove": True, "d_lda": 0.3, "nroots": 10,
        "tol": None, "max_space_factor": 12, "pick_positive": False}
FLIP_LIMITS = {"solves_compared": 2, "ref_tol": 1e-6, "sigma_err": {"limit": 4e-3},
               "root_err": {"limit": 1e-4}}
REHEARSED = sorted(CELLS) + ["flip"]


@functools.lru_cache(maxsize=None)
def tiny_checkpoint(path: str, nc: int, no: int, nv: int) -> tuple[str, str]:
    """(path, sha256) of a checkpoint cut from ``path`` to nc | no | nv
    orbitals: the highest core, the open shells and the lowest virtuals of
    its MO Fock matrices, with identity orbitals.  Written to a temporary
    file that is removed when the process ends."""
    from xbench import inputs

    with np.load(inputs.REPO / path) as d:
        occ, C = d["mo_occ"], d["mo_coeff"]
        core, open_, virt = (np.where(occ >= 2)[0], np.where(occ == 1)[0],
                             np.where(occ == 0)[0])
        pick = np.concatenate([core[len(core) - nc:], open_[:no], virt[:nv]])
        fa, fb = ((C.T @ d[k] @ C)[np.ix_(pick, pick)] for k in ("fock_a", "fock_b"))
    fd, name = tempfile.mkstemp(suffix=".npz")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, mo_occ=np.array([2.0] * nc + [1.0] * no + [0.0] * nv),
                 mo_coeff=np.eye(nc + no + nv), fock_a=fa, fock_b=fb)
    atexit.register(os.unlink, name)
    return name, hashlib.sha256(pathlib.Path(name).read_bytes()).hexdigest()


def tiny_cfg(cfg: dict) -> dict:
    """The configuration ``cfg`` at the CPU's size, its checkpoint cut to match."""
    cfg = dict(cfg, **TINY)
    path, sha = tiny_checkpoint(cfg["fock"]["path"], cfg["nc"], cfg["no"], cfg["nv"])
    cfg["fock"] = dict(cfg["fock"], path=path, sha256=sha)
    return cfg


def tiny_cell(name: str):
    """The cell ``name`` (or ``"flip"``) cut to the CPU's size: the
    configuration's widths and the traffic's root count shrunk, the
    checkpoint cut to the widths, the cell's limits."""
    from xbench import cell as xcell

    if name == "flip":
        name, traffic, limits = sorted(CELLS)[0], FLIP, FLIP_LIMITS
    else:
        traffic = json.loads((BENCH / "traffic" / f"{CELLS[name][1]}.json").read_text())
        limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())
    return xcell.Cell(
        name=name, chips=1, cfg=tiny_cfg(json.loads((BENCH.parent / CELLS[name][0]).read_text())),
        traffic=dict(traffic, nroots=4), limits=limits,
        end_to_end=[{"name": "solve_s", "unit": "s"}, {"name": "setup_s", "unit": "s"}],
        per_layer=[])
