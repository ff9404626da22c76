"""A whole run of every cell, cut to the CPU's size: the data path from the
seed through the window and the check, with the cells' own limits."""

import io
import json
import time

import pytest
from bench_tiny import CELLS, REHEARSED, tiny_cell

from xbench import cell as xcell


@pytest.mark.parametrize("name", REHEARSED)
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_run_is_correct(name, trace):
    out, err = io.StringIO(), io.StringIO()
    c = tiny_cell(name)
    if trace:
        c.per_layer = [{"name": n, "unit": "x"} for n in
                       ("solve.mfu", "operator.ms", "sigma.ms", "sigma.roofline", "davidson.builds",
                        "davidson.self_ms", "k1.roofline", "grid.roofline", "device.idle")]
    res = xcell.run(c, 2**31 + 5, 0.2, trace, "cpu", time.perf_counter(), out=out, err=err)
    line = json.loads(out.getvalue().splitlines()[-1])
    assert line == json.loads(json.dumps(res))
    assert res["correct"], err.getvalue()
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert list(line)[-1] == "check"
    assert err.getvalue().splitlines()[-1] == "failed_solves 0 limit 0"
    if trace:
        m = res["metrics"]
        # no device trace on the CPU: the trace's readers find nothing
        assert not {"k1.roofline", "grid.roofline", "device.idle"} & set(m)
        assert m["davidson.builds"]["value"] >= 1 and m["sigma.ms"]["value"] > 0
        assert 0 < m["solve.mfu"]["value"] < m["sigma.roofline"]["value"] * 1.01
    else:
        assert set(res["metrics"]) == {"solve_s", "setup_s"}
