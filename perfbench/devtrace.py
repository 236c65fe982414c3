"""The device trace of a measured window: `torch.profiler` over the window,
its Chrome trace read back into device intervals (kernels, copies, fills)
and host events, clipped to the window's own annotation.

What the per-layer metrics read from it: kernel seconds by name pattern,
the union of device intervals (busy seconds), the window's span, the
device operations that took most time, and the idle gaps labelled by the
host event that was running across them.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
from collections import defaultdict

import torch

WINDOW = "perfbench.window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "cuda_runtime", "cuda_driver", "user_annotation"}


class Trace:
    """Device and host events of one traced window (seconds)."""

    def __init__(self, events: list[dict], epochs: int, runs: int):
        win = [e for e in events if e.get("cat") == "user_annotation" and e.get("name") == WINDOW]
        if not win:
            raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
        t0 = float(win[0]["ts"])
        t1 = t0 + float(win[0]["dur"])
        self.span_s = (t1 - t0) * 1e-6
        self.epochs, self.runs = epochs, runs

        def clip(e):
            a, b = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))
            a, b = max(a, t0), min(b, t1)
            return (a, b) if b > a else None

        self.device = []  # (name, cat, start_us, end_us)
        self.host = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            if cat in DEVICE_CATS or (cat in HOST_CATS and e.get("name") != WINDOW):
                iv = clip(e)
                if iv is not None:
                    (self.device if cat in DEVICE_CATS else self.host).append(
                        (e.get("name", ""), cat, *iv))
        self.t0, self.t1 = t0, t1

    def kernel_seconds(self, include=None, exclude=None) -> float:
        """Seconds of kernels whose name matches `include` (all where None)
        and not `exclude`."""
        return 1e-6 * sum(b - a for name, cat, a, b in self.device
                          if cat == "kernel" and (include is None or include.search(name))
                          and not (exclude is not None and exclude.search(name)))

    def _busy(self) -> list[tuple[float, float]]:
        merged = []
        for a, b in sorted((a, b) for _, _, a, b in self.device):
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        return 1e-6 * sum(b - a for a, b in self._busy())

    def top_ops(self, n: int = 10) -> list:
        total = defaultdict(float)
        for name, _, a, b in self.device:
            total[name] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle gaps inside the window, summed by the innermost
        host event that spans each gap's middle ("host, untraced" where
        none does)."""
        edges = [self.t0] + [x for iv in self._busy() for x in iv] + [self.t1]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        hosts = sorted(self.host, key=lambda h: h[2])
        total = defaultdict(float)
        active, i = [], 0  # a heap of (end, duration, name) of started events
        for a, b in gaps:  # in time order: sweep the host events once
            mid = 0.5 * (a + b)
            while i < len(hosts) and hosts[i][2] <= mid:
                name, _, s, e = hosts[i]
                heapq.heappush(active, (e, e - s, name))
                i += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            label = min(active, key=lambda x: x[1])[2] if active else "host, untraced"
            total[label] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:n]


def traced(fn, device: torch.device):
    """fn() under torch.profiler (CPU and, on the card, CUDA activity) inside
    the window annotation. Returns (fn's result, the profiler's events)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            out = fn()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, events
