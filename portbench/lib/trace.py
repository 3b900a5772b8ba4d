"""The traced run's profiler: ``torch.profiler`` over the first part of
the window, reduced to device intervals, busy time and idle gaps."""
from __future__ import annotations

import re
import time
from pathlib import Path
from typing import Dict, List, Optional

from portbench.metrics import _yardstick as ys

MARK = "portbench.traced"


class Tracer:
    """Profiles from ``start`` until ``maybe_stop`` is called past
    ``seconds`` (at a request boundary, so no request is cut), or ``stop``.
    Off (every call a no-op) in an untraced run."""

    def __init__(self, on: bool, seconds: float, rec, device):
        self.on = on
        self.seconds = seconds
        self.rec = rec
        self.device = device
        self.prof = None
        self.mark = None
        self.t0 = self.t1 = 0.0
        self.events: list = []

    def start(self) -> None:
        if not self.on:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.mark = torch.profiler.record_function(MARK)
        self.mark.__enter__()
        self.rec.profiling = True
        self.t0 = time.perf_counter()

    def maybe_stop(self) -> None:
        if self.prof is not None and time.perf_counter() - self.t0 >= self.seconds:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        self.rec.sync()
        self.mark.__exit__(None, None, None)
        self.t1 = time.perf_counter()
        self.rec.profiling = False
        self.prof.__exit__(None, None, None)
        self.events = list(self.prof.profiler.kineto_results.events())
        self.prof = None


def own_kernels(csrc: Path) -> set:
    """The names of the program's own kernels: every ``__global__``
    function of its CUDA sources."""
    names = set()
    for p in sorted(csrc.glob("*.cu")):
        text = p.read_text()
        names |= set(re.findall(r"__global__\s+(?:void\s+)?(?:__launch_bounds__"
                                r"\([^)]*\)\s*)?(?:void\s+)?(\w+)\s*\(",
                                text))
    return names


def is_own(name: str, own: set) -> bool:
    base = re.sub(r"^void\s+", "", name).split("(")[0].split("<")[0].strip()
    return base.split("::")[-1] in own


class Trace:
    """What the per-layer readers read: the recorder's spans, the
    counters, and (in a traced run) the device's intervals in the
    profiled window ``[lo, hi)`` (nanoseconds of the profiler's clock)."""

    def __init__(self, rec, counters: Dict[str, object], sizes: Dict,
                 tracer: Optional[Tracer], own: set):
        from torch.autograd import DeviceType

        self.spans = rec.spans
        self.counters = counters
        self.sizes = sizes
        self.own = own
        self.device_ops: List[tuple] = []   # (name, start_ns, end_ns)
        self.annotations: List[tuple] = []  # host ranges (name, start, end)
        self.lo = self.hi = 0
        self.window_s = 0.0
        self.traced = bool(tracer is not None and tracer.events)
        if not self.traced:
            return
        for e in tracer.events:
            start, dur = e.start_ns(), e.duration_ns()
            if e.is_user_annotation():
                if e.device_type() == DeviceType.CPU:
                    self.annotations.append((e.name(), start, start + dur))
                continue
            if e.device_type() == DeviceType.CUDA and dur > 0:
                self.device_ops.append((e.name(), start, start + dur))
        marks = [a for a in self.annotations if a[0] == MARK]
        if marks:
            _, self.lo, self.hi = marks[0]
        self.window_s = tracer.t1 - tracer.t0
        self.device_ops = [(n, a, b) for n, a, b in self.device_ops
                           if b > self.lo and a < self.hi]

    def is_own(self, name: str) -> bool:
        return is_own(name, self.own)

    def busy(self) -> List[tuple]:
        return ys.busy_union(ys.clip([(a, b) for _, a, b in self.device_ops],
                                     self.lo, self.hi))

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e9

    def device_s(self, pick=lambda name: True) -> float:
        """Seconds of device operations whose name ``pick`` accepts (each
        operation's own duration, inside the profiled window)."""
        return sum(b - a for n, a, b in ys.clip_named(self.device_ops,
                                                      self.lo, self.hi)
                   if pick(n)) / 1e9

    def breakdown(self) -> Dict[str, list]:
        """The ten device operations that took most time, and the ten
        longest idle gaps, each by the innermost span of the benchmark's
        that was open over its middle."""
        ops = ys.top_by_name(((n, (b - a) / 1e9) for n, a, b in
                              ys.clip_named(self.device_ops, self.lo,
                                            self.hi)), 10)
        spans = [a for a in self.annotations if a[0] != MARK]
        gaps = sorted(ys.idle_gaps(self.busy(), self.lo, self.hi),
                      key=lambda g: g[0] - g[1])[:10]
        named = []
        for a, b in gaps:
            mid = (a + b) // 2
            inner = [s for s in spans if s[1] <= mid < s[2]]
            label = (min(inner, key=lambda s: s[2] - s[1])[0] if inner
                     else "outside the benchmark's spans")
            named.append([label, (b - a) / 1e9])
        return {"device_ops": ops, "idle_gaps": named}
