"""The micro-batching request loop over ``QueryEngine.sample_batch``: the
per-engine serving core, shared by the single-engine serve loop and every
fleet replica.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.engine import query_fingerprint
from repro_torch.kernels import threefry

__all__ = ["JoinSampleRequest", "UpdateRequest", "MicroBatcher",
           "serve_join_samples"]


@dataclasses.dataclass
class JoinSampleRequest:
    """One tenant request: draw an independent Poisson sample of ``query``
    under the key ``threefry.key(seed)``."""

    query: "JoinQuery"
    seed: int = 0
    count: Optional[int] = None       # filled by the service
    overflow: Optional[bool] = None   # filled by the service
    latency_s: Optional[float] = None  # enqueue -> results routed back
    enqueued_s: Optional[float] = None  # set by MicroBatcher.submit
    db_version: Optional[int] = None  # snapshot version the draw was served from
    rows: Optional[Dict[str, np.ndarray]] = None  # collect_rows=True only


@dataclasses.dataclass
class UpdateRequest:
    """One tenant update: advance the engine's snapshot by ``delta`` (a
    ``core.delta.DeltaBatch``). Serialized against draws by the micro-batch
    loop: draws enqueued before the update are flushed against the
    pre-delta snapshot first, so no in-flight batch ever mixes versions."""

    delta: object
    applied_version: Optional[int] = None  # post-apply db version
    latency_s: Optional[float] = None
    enqueued_s: Optional[float] = None


class MicroBatcher:
    """Micro-batching front end over ``QueryEngine.sample_batch``.

    Requests accumulate in an arrival-ordered queue and are flushed as
    batched dispatches when either trigger fires:

      * **size** — the queue reaches ``max_batch`` requests;
      * **deadline** — the oldest pending request has waited
        ``max_wait_ms`` (checked by ``poll()``, which the serving loop
        calls between arrivals).

    A flush groups pending requests by query fingerprint and issues ONE
    ``sample_batch`` dispatch per distinct shape (one plan per shape in
    the engine's cache, reused across flushes); per-request results are
    routed back by lane index. ``clock`` is injectable so deadline behavior
    is testable.

    ``UpdateRequest``s interleave with draws: an update is a barrier —
    pending draws flush first (reading the pre-delta snapshot), then the
    delta is applied via ``engine.apply_delta`` (warm cache entries upgrade
    in place), and draws submitted afterwards read the new version. Every
    completed draw records the ``db_version`` it was served from.

    ``collect_rows=True`` also copies each draw's valid rows (the first
    ``count`` lanes) to the host as numpy onto ``JoinSampleRequest.rows``,
    which the fleet's determinism checks compare bit for bit. Off by
    default: it moves every column of a flush to the host.

    ``mesh`` / ``axes`` pass to every ``sample_batch``: the engine's
    sharded plan serves the flush (``launch.mesh``).
    """

    def __init__(self, engine, *, max_batch: int = 64,
                 max_wait_ms: float = 2.0, mesh=None, axes=None,
                 clock=time.perf_counter, collect_rows: bool = False):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.engine = engine
        self.mesh = mesh
        self.axes = axes
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.clock = clock
        self.collect_rows = collect_rows
        self.pending: List[JoinSampleRequest] = []
        self.flushes = 0
        self.dispatches = 0
        self.served = 0
        self.updates_applied = 0

    def submit(self, req) -> List:
        """Enqueue one request; returns completed requests (non-empty only
        when this arrival triggered work: a full batch for draws, or the
        flush-then-apply barrier for updates)."""
        req.enqueued_s = self.clock()
        if isinstance(req, UpdateRequest):
            return self._apply_update(req)
        self.pending.append(req)
        if len(self.pending) >= self.max_batch:
            return self.flush()
        return []

    def _apply_update(self, req: UpdateRequest) -> List:
        """The update barrier: drain pending draws on the current snapshot,
        then advance it."""
        done = self.flush()
        self.engine.apply_delta(req.delta)
        req.applied_version = self.engine.db.version
        req.latency_s = self.clock() - req.enqueued_s
        self.updates_applied += 1
        return done + [req]

    def poll(self) -> List[JoinSampleRequest]:
        """Deadline check: flush iff the oldest pending request has waited
        at least ``max_wait_ms``. Call between arrivals / when idle."""
        if self.pending and \
                (self.clock() - self.pending[0].enqueued_s) * 1e3 >= self.max_wait_ms:
            return self.flush()
        return []

    def flush(self) -> List[JoinSampleRequest]:
        """Dispatch everything pending now (one batched draw per distinct
        query fingerprint) and route results back to their requests."""
        batch, self.pending = self.pending, []
        if not batch:
            return []
        groups: Dict[str, List[JoinSampleRequest]] = {}
        for r in batch:
            groups.setdefault(query_fingerprint(r.query), []).append(r)
        version = self.engine.db.version
        for reqs in groups.values():
            keys = np.stack([threefry.key(r.seed) for r in reqs])
            smp = self.engine.sample_batch(reqs[0].query, keys,
                                           mesh=self.mesh, axes=self.axes)
            # The host read waits for the device: the stamp below covers
            # the draw's work on the card.
            counts = smp.count.cpu().numpy()
            done_t = self.clock()
            overflow = smp.overflow.cpu().numpy()
            cols = ({c: v.cpu().numpy() for c, v in smp.columns.items()}
                    if self.collect_rows else None)
            for lane, r in enumerate(reqs):
                r.count = int(counts[lane])
                r.overflow = bool(overflow[lane])
                r.latency_s = done_t - r.enqueued_s
                r.db_version = version
                if cols is not None:
                    r.rows = {c: v[lane, : r.count].copy()
                              for c, v in cols.items()}
            self.dispatches += 1
        self.flushes += 1
        self.served += len(batch)
        return batch


def serve_join_samples(engine, requests: List, mesh=None,
                       max_batch: int = 64, max_wait_ms: float = 2.0,
                       collect_rows: bool = False) -> List:
    """Serve a request list through the micro-batcher (closed loop: submit
    everything, then drain). The list may interleave ``JoinSampleRequest``
    draws with ``UpdateRequest`` deltas; updates barrier the stream in
    arrival order. Results are routed back onto the request objects.

    This is also the fleet's single-engine *baseline*: ``Fleet`` serving
    the same stream reproduces these results bit for bit per
    (seed, version)."""
    mb = MicroBatcher(engine, max_batch=max_batch, max_wait_ms=max_wait_ms,
                      mesh=mesh, collect_rows=collect_rows)
    done: List[JoinSampleRequest] = []
    for r in requests:
        done += mb.submit(r)
        done += mb.poll()
    done += mb.flush()  # drain the tail regardless of deadline
    return done
