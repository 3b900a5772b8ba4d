"""What a window records: the benchmark's own spans around calls into the
program, the requests' latencies on the benchmark's clock, and a seeded
sample of the outputs for the judge."""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np


class Recorder:
    """Host spans ``(name, start_s, end_s, info)`` on ``time.perf_counter``.
    In a traced run each span also opens a ``torch.profiler`` range named
    ``portbench.<name>`` and waits for the card before it closes, so that
    it covers the device work its call enqueued."""

    def __init__(self, traced: bool, sync: Callable[[], None]):
        self.traced = traced
        self.sync = sync
        self.spans: List[tuple] = []
        self.recording = False   # inside the window
        self.profiling = False   # inside the profiler's part of it

    @contextlib.contextmanager
    def span(self, name: str, **info):
        if not self.recording:
            yield info
            return
        info["profiled"] = self.profiling
        t0 = time.perf_counter()
        if self.traced:
            import torch
            with torch.profiler.record_function("portbench." + name):
                yield info
                self.sync()
        else:
            yield info
        self.spans.append((name, t0, time.perf_counter(), info))

    def named(self, name: str) -> List[tuple]:
        return [s for s in self.spans if s[0] == name]


def device_bytes(item) -> int:
    """Bytes of the CUDA storages that ``item`` (a tensor, or a dict, list,
    tuple or object of them) holds, each storage once."""
    import torch

    seen, stack = {}, [item]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                st = x.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif hasattr(x, "__dict__"):
            stack.extend(vars(x).values())
    return sum(seen.values())


class PeakMeter:
    """The program's peak of allocated device memory, without the outputs
    the benchmark keeps for the judge. Between two marks the kept outputs
    do not change, so the allocator's peak over that stretch less what
    they held is the program's own; ``mark`` closes the stretch and says
    what is kept from then on."""

    def __init__(self, device):
        self.device = device
        self.on = device.type == "cuda"
        self.held = 0
        self.peak = 0
        self.with_kept = 0   # the allocator's own peak, kept outputs in it

    def start(self) -> None:
        if self.on:
            import torch
            torch.cuda.reset_peak_memory_stats(self.device)

    def mark(self, held_now: int) -> None:
        if self.on:
            import torch
            now = int(torch.cuda.max_memory_allocated(self.device))
            self.peak = max(self.peak, now - self.held)
            self.with_kept = max(self.with_kept, now)
            torch.cuda.reset_peak_memory_stats(self.device)
        self.held = held_now


class Reservoir:
    """A uniform sample of at most ``k`` of the items offered, drawn from
    ``rng`` (reservoir sampling): the sample the judge checks, fixed by the
    seed for a given number of items. Items not kept are dropped at once,
    so the card holds at most ``k`` outputs beside the program's own. With a ``meter``, each
    offer marks what the reservoir holds, so the kept outputs stay out of
    the program's peak."""

    def __init__(self, k: int, rng: np.random.Generator,
                 meter: Optional[PeakMeter] = None):
        self.k = k
        self.rng = rng
        self.meter = meter
        self.items: List[object] = []
        self.offered = 0

    def restart(self, k: int, rng: np.random.Generator) -> None:
        """Drop what is kept and sample anew: ``k`` of the items offered
        from now on, drawn from ``rng``."""
        self.k, self.rng = k, rng
        self.items, self.offered = [], 0
        if self.meter is not None:
            self.meter.mark(0)

    def offer(self, item) -> None:
        if self.meter is not None:
            self.meter.mark(self.meter.held)
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.offered + 1))
            if j < self.k:
                self.items[j] = item
        self.offered += 1
        if self.meter is not None:
            self.meter.held = self.held_bytes()

    def held_bytes(self) -> int:
        return sum(device_bytes(it) for it in self.items)


class EngineProxy:
    """The engine as the batcher sees it: every call passes through, timed
    by the recorder; each batch of draws is offered to ``keep`` with the
    snapshot version it was served from."""

    def __init__(self, engine, rec: Recorder,
                 keep: Optional[Callable[[object, int], None]] = None):
        self._engine = engine
        self._rec = rec
        self.keep = keep

    def sample_batch(self, query, keys, **kw):
        version = self._engine.db.version
        with self._rec.span("sample_batch", keys=len(keys)) as info:
            smp = self._engine.sample_batch(query, keys, **kw)
            if self._rec.traced and self._rec.recording:
                info["counts"] = smp.count.cpu().tolist()
        if self.keep is not None:
            self.keep(smp, version)
        return smp

    def apply_delta(self, delta):
        with self._rec.span("apply_delta"):
            self._engine.apply_delta(delta)
        return self

    def __getattr__(self, name):
        return getattr(self._engine, name)


class Window:
    """One measured window: its bounds on the host clock, each completed
    request's latency by kind, and the outputs kept for the judge."""

    def __init__(self):
        self.t_open = 0.0
        self.t_close = 0.0
        self.latencies: Dict[str, List[float]] = {}
        self.kept: Dict[str, object] = {}
        self.counters: Dict[str, object] = {}
        self.open = False   # between the window's open and close

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    def done(self, kind: str, latency_s: float) -> None:
        """A request of ``kind`` completed; counted only inside the
        window (warm-up requests are not)."""
        if self.open:
            self.latencies.setdefault(kind, []).append(latency_s)
