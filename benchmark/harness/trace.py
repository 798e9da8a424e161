"""The profiler's trace of a run's window, reduced to what the metrics read.

The harness wraps its run in ``torch.profiler.profile`` over the host's
calling thread and, on a card, the card's kernels, copies and memsets.
Host operations of the program's other threads are not traced: the
per-layer metrics read none of them, and tracing them slows the host
pipeline that sets the pace.  The window and each pass are marked with
``record_function`` (``bench.window``, ``bench.pass``), and so is each
stage that the program enters on the calling thread with the harness's
timers (``stage.<name>``, :class:`TracedTimers`).

:func:`reduce_trace` reads one card's events inside the window from the
exported Chrome trace: the union of its busy intervals (kernels, copies
and memsets on every stream), the summed time of each device operation,
the time of every operation except host-to-device copies, and each idle
gap, named by the innermost marked range of the calling thread that holds
its middle (the longest :data:`TOP` gaps).
"""

from __future__ import annotations

import contextlib
import json
import os

import torch

from hpgq_torch.utils.timers import StageTimers

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10  # the longest idle gaps named


class TracedTimers(StageTimers):
    """The program's stage timers, each stage also a marked range in the
    profiler's trace."""

    @contextlib.contextmanager
    def stage(self, name: str):
        with torch.profiler.record_function("stage." + name):
            with super().stage(name):
                yield


def profiler(device: torch.device):
    """A profiler of the calling thread and, on CUDA, of the card."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def export(prof, directory: str) -> str:
    path = os.path.join(directory, "trace.%d.json" % os.getpid())
    prof.export_chrome_trace(path)
    return path


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_trace(path: str, device_index) -> dict:
    """``{"window_s", "busy_s", "ops_s", "non_h2d_s", "gaps"}`` of the card
    ``device_index`` (None: no card) inside the ``bench.window`` range.
    ``ops_s`` maps a device operation's name to its seconds; ``gaps``
    holds the :data:`TOP` longest idle gaps as ``(name of the host's range,
    seconds)``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("ph") == "X"]
    win = [e for e in marks if e["name"] == "bench.window"]
    if not win:
        raise ValueError("the trace holds no bench.window range")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    tid = win[0].get("tid")
    marks = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in marks if e.get("tid") == tid), key=lambda m: m[0])
    busy, ops, non_h2d = [], {}, 0.0
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        dev = e.get("args", {}).get("device", e.get("pid", -1))
        if device_index is None or int(dev) != device_index:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        busy.append((a, b))
        ops[e["name"]] = ops.get(e["name"], 0.0) + (b - a) * 1e-6
        if "HtoD" not in e["name"]:
            non_h2d += (b - a) * 1e-6
    merged = _union(busy)
    busy_us = sum(b - a for a, b in merged)
    idle, at = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > at:
            idle.append((at, a))
        at = max(at, b)
    gaps = []
    for a, b in sorted(idle, key=lambda g: g[0] - g[1])[:TOP]:
        mid = 0.5 * (a + b)
        inner = [m for m in marks if m[0] <= mid <= m[1]]
        gaps.append((inner[-1][2] if inner else "outside the window",
                     (b - a) * 1e-6))
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_us * 1e-6,
            "ops_s": ops, "non_h2d_s": non_h2d, "gaps": gaps}
