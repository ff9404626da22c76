"""The benchmark is data: every file that BENCHMARK.json names is there and
loads, every name and unit is made of the allowed characters, and every
cell reports the end-to-end metric that each of its layer metrics moves."""

import json
import re

import pytest

from xbench import cell as xcell
from xbench import check

BENCH = json.loads((xcell.REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert LINE.match(c["why"]) and LINE.match(c["source"])
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert LINE.match(m["layer"])
    for w in BENCH["workloads"]:
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
    for word in BENCH["command"]:
        assert LINE.match(word)
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_by_name(name):
    c = xcell.load_cell(name)
    assert c.traffic["method"] in ("xtda", "xsf")
    for key in ("nc", "no", "nv", "naux", "ngrid", "xc", "dtype", "b_rank", "fock"):
        assert key in c.cfg, key
    assert check.compared(c.limits)
    for k in check.compared(c.limits):
        lim = c.limits[k]
        assert lim["lower"] < lim["limit"] < lim["upper"], (k, lim)
        assert lim["upper"] >= 3 * lim["lower"], (k, lim)
    assert c.limits["solves_compared"] >= 1
    reported = {m["name"] for m in c.end_to_end}
    assert {"setup_s"} < reported
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reported, (name, m["name"])
        assert callable(xcell.load_metric(m["name"]).read)


def test_configuration_files_and_their_keys():
    for conf in BENCH["configs"]:
        path = xcell.REPO / conf["file"]
        assert path.parts[-3:-1] == ("benchmark", "configs")
        cfg = json.loads(path.read_text())
        assert cfg["name"] == conf["name"]
        assert sorted(cfg.get("reduced", {})) == sorted(conf["reduced"])
        assert cfg["nc"] + cfg["no"] + cfg["nv"] > 0


def test_per_layer_metrics_have_their_readers():
    for m in BENCH["per_layer"]:
        assert (xcell.HERE / "metrics" / f"{m['name']}.py").is_file()
