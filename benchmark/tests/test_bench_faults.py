"""The check refuses a broken program and its control.

Each fault is planted under a whole run of the cell at the CPU's size (the
harness's look for a card skipped): a sigma build that returns its state
unchanged, one that leaves half of its vectors out and gives them the mean
of the rest, a root altered where the Davidson produces it.  One chip holds
the whole state, so there is no exchange between chips to leave out.  The
control, the reference computed in the precision below the
configuration's (TF32 products for the f32 cells, which exist only on the
card), must come out not correct too.
"""

import io
import time

import numpy as np
import pytest
import torch
from bench_tiny import CELLS, REHEARSED, tiny_cell

from xbench import cell as xcell
from xbench import check
from xbench.inputs import make_inputs


class StateUnchanged(xcell.Port):
    def operator(self, traffic):
        op = super().operator(traffic)
        op.matvec = lambda z: torch.as_tensor(z).clone()
        return op


class HalfBatch(xcell.Port):
    def operator(self, traffic):
        op = super().operator(traffic)
        full = op.matvec

        def half(z):
            n = max(1, z.shape[0] // 2)
            out = full(z[:n])
            return torch.cat([out, out.mean(0, keepdim=True).expand(z.shape[0] - n, -1)])
        op.matvec = half
        return op


class AlteredRoot(xcell.Port):
    @staticmethod
    def solve(op, matvec, traffic, x0):
        e, v, conv, info = xcell.Port.solve(op, matvec, traffic, x0)
        e = np.array(e)
        e[0] += 1e-3
        return e, v, conv, info


@pytest.mark.parametrize("name", REHEARSED)
@pytest.mark.parametrize("fault", [StateUnchanged, HalfBatch, AlteredRoot])
def test_fault_is_not_correct(name, fault):
    err = io.StringIO()
    res = xcell.run(tiny_cell(name), 2**31 + 17, 0.1, False, "cpu", time.perf_counter(),
                    port_cls=fault, out=io.StringIO(), err=err)
    assert not res["correct"], err.getvalue()


def _control_correct(name, device, seed):
    c = tiny_cell(name)
    inp = make_inputs(c.cfg, seed, device)
    tf32 = c.cfg["dtype"] == "float32"
    s = check.control_sample(inp, c.traffic, torch.float32, tf32)
    values = check.readings(inp, c.traffic, [s], c.limits["ref_tol"])
    return check.judge(values, c.limits, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CELLS))
def test_control_of_each_cell_is_not_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("the controls run on a CUDA card (TF32 products exist only there)")
    ok, lines = _control_correct(name, "cuda", 2**31 + 29)
    assert not ok, lines
