"""The device side of a traced window, from ``torch.profiler``'s trace.

The profiler's Chrome trace is written to a file in the temporary
directory, read back and deleted.  Kept from it: every kernel, copy and
memset on the card (name, start, duration), the benchmark's own host spans
(``bench.*`` ranges of ``record_function``) and the host's operators.
"""

from __future__ import annotations

import dataclasses
import heapq
import json
import os
import tempfile
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


@dataclasses.dataclass
class DeviceTrace:
    kernels: dict        # name -> device seconds inside the window
    busy_s: float        # seconds of the window with an operation on the card
    window_s: float      # from the first traced solve's start to the last one's end
    device_ops: list     # [[name, seconds]] the operations that took most time
    idle_gaps: list      # [[what the host was doing, seconds]] the longest idle time


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(spans, times):
    """For each of the ascending ``times``, the name of the shortest of
    ``spans`` [(start, end, name)] that holds it (None if none does): one
    sweep, the open spans in a heap by duration."""
    spans = sorted(spans)
    heap, out, k = [], [], 0
    for t in times:
        while k < len(spans) and spans[k][0] <= t:
            a, b, name = spans[k]
            heapq.heappush(heap, (b - a, b, name))
            k += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def read(prof) -> DeviceTrace:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    dev, bench, ops = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat, name = e.get("cat"), e.get("name", "")
        if cat in DEVICE_CATS:
            dev.append((a, b, name))
        elif cat == "user_annotation" and name.startswith("bench."):
            bench.append((a, b, name))
        elif cat == "cpu_op":
            ops.append((a, b, name))
    solves = [(a, b) for a, b, n in bench if n == "bench.solve"]
    if not solves or not dev:
        return DeviceTrace({}, 0.0, 0.0, [], [])
    w0, w1 = min(a for a, _ in solves), max(b for _, b in solves)
    kernels = defaultdict(float)
    clipped = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b > a:
            kernels[name] += (b - a) * 1e-6
            clipped.append((a, b))
    busy = _union(clipped)
    idle, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    mids = [0.5 * (a + b) for a, b in idle]
    gaps = defaultdict(float)
    for (a, b), span, op in zip(idle, _innermost(bench, mids), _innermost(ops, mids)):
        gaps[f"{span or '-'} / {op or '-'}"] += (b - a) * 1e-6
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:TOP]
    return DeviceTrace(
        kernels=dict(kernels), busy_s=sum(b - a for a, b in busy) * 1e-6,
        window_s=(w1 - w0) * 1e-6, device_ops=[[n[:200], s] for n, s in top],
        idle_gaps=[[n[:200], s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]])
