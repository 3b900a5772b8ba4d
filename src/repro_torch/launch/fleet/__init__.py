"""repro_torch.launch.fleet — the replicated serving library.

One router, N engine replicas, an append-only delta log, and an
in-process deterministic transport:

    from repro_torch.launch.fleet import Fleet, JoinSampleRequest, UpdateRequest

    fleet = Fleet(db, replicas=4)                            # db on the card
    res = fleet.submit(JoinSampleRequest(query=q, seed=7))   # None | Rejected
    fleet.submit(UpdateRequest(delta))                       # commit = log append
    done = fleet.drain()                                     # every accepted req

Draws are pure given (query, seed, version), updates are totally ordered
by the log, and replicas apply deltas at version barriers — so the fleet's
per-seed results are bit-identical to the single-engine micro-batcher
serving the same stream, replica crashes included (the router's retry is
exact). No sockets anywhere: the transport is a discrete-event loop with
an injectable clock and a fault-injection hook, which is what makes the
crash/drop/delay tests and the determinism harness deterministic.

Every replica's engine lives on the database's device under the fleet's
``kernel_policy`` (``None``: the default ``KernelPolicy``). A replica
serves on one engine without a mesh, as in the reference; the
micro-batcher takes one (``MicroBatcher(mesh=)``).

Public API:
    Fleet              router + replicas + log behind one facade
    serve_fleet        closed-loop serving of a request stream
    Router, Rejected   admission control + affine routing + exact retry
    Replica            one engine + micro-batcher behind a mailbox
    Transport, SimClock, FaultInjector, DROP, CRASH
    DeltaLog           append-only DeltaBatch log with LSNs
    MicroBatcher, JoinSampleRequest, UpdateRequest, serve_join_samples
"""
from __future__ import annotations

import time
from typing import List, Optional, Union

from repro_torch.engine import CacheStats

from .batcher import (
    JoinSampleRequest, MicroBatcher, UpdateRequest, serve_join_samples,
)
from .log import DeltaLog
from .replica import DOWN, DRAINING, UP, Replica
from .router import Rejected, Router
from .transport import CRASH, DROP, FaultInjector, SimClock, Transport

__all__ = [
    "Fleet", "serve_fleet", "Router", "Rejected", "Replica", "Transport",
    "SimClock", "FaultInjector", "DROP", "CRASH", "DeltaLog", "MicroBatcher",
    "JoinSampleRequest", "UpdateRequest", "serve_join_samples",
    "UP", "DRAINING", "DOWN",
]


class Fleet:
    """N replicas behind a router, serving one database lineage.

    ``clock="sim"`` (default) runs on a ``SimClock`` — time moves only via
    ``advance``, so tests are fully deterministic; ``clock="real"`` uses
    ``time.perf_counter`` for meaningful latencies (demo, benchmark).
    """

    def __init__(self, db, *, replicas: int = 2, max_batch: int = 8,
                 max_wait_ms: float = 2.0, max_inflight: int = 64,
                 retry_timeout_s: float = 0.25, clock="sim",
                 faults: Optional[FaultInjector] = None,
                 collect_rows: bool = False, kernel_policy=None):
        if replicas < 1:
            raise ValueError(f"need at least one replica, got {replicas}")
        if clock == "sim":
            clock = SimClock()
        elif clock == "real":
            clock = time.perf_counter
        self.transport = Transport(clock=clock, faults=faults)
        self.log = DeltaLog(base_version=db.version)
        self.replicas = [
            Replica(f"replica{i}", db, self.log, self.transport,
                    max_batch=max_batch, max_wait_ms=max_wait_ms,
                    collect_rows=collect_rows, kernel_policy=kernel_policy)
            for i in range(replicas)
        ]
        self.router = Router(self.transport, self.log,
                             [r.name for r in self.replicas],
                             max_inflight=max_inflight,
                             retry_timeout_s=retry_timeout_s)

    # -- serving -------------------------------------------------------------
    def submit(self, req) -> Optional[Rejected]:
        """Admit one request and deliver everything already due. Returns
        ``Rejected`` or None; harvest completions via ``take_completed``."""
        res = self.router.submit(req)
        self.transport.pump()
        return res

    def take_completed(self) -> List[object]:
        return self.router.take_completed()

    def advance(self, dt: float) -> List[object]:
        """SimClock: move time forward (deadline flushes, retry timers fire
        on schedule) and return what completed."""
        self.transport.advance(dt)
        return self.take_completed()

    def pump(self) -> List[object]:
        self.transport.pump()
        return self.take_completed()

    def drain(self) -> List[object]:
        """Flush every replica, catch them all up to the log head, and
        return every remaining completion. After this the fleet rejects."""
        self.router.start_drain()
        self.transport.run()
        return self.take_completed()

    def crash(self, replica: Union[int, str]) -> None:
        """Test/demo hook: fail-stop one replica right now."""
        r = self.replicas[replica] if isinstance(replica, int) else \
            next(x for x in self.replicas if x.name == replica)
        r.crash()
        self.transport.pump()

    # -- observability -------------------------------------------------------
    def stats(self) -> CacheStats:
        """Replica-aware aggregation: field-wise sum of every replica's
        engine CacheStats (affinity shows up as one plan miss per shape
        per homing replica)."""
        return CacheStats.aggregate(r.engine.stats for r in self.replicas)

    def health(self) -> dict:
        return dict(self.router.health)

    @property
    def db_version(self) -> int:
        """The committed version (log head) — replicas converge to it at
        their next barrier; ``drain`` forces convergence."""
        return self.log.head_version


def serve_fleet(db, requests: List, *, replicas: int = 2, max_batch: int = 8,
                max_wait_ms: float = 2.0, max_inflight: int = 256,
                retry_timeout_s: float = 0.25, clock="sim",
                faults: Optional[FaultInjector] = None,
                collect_rows: bool = False,
                arrival_gap_s: float = 0.0,
                crash_at: Optional[int] = None,
                crash_replica: int = 0, kernel_policy=None) -> List[object]:
    """Closed-loop fleet serving: submit the stream in order, drain, and
    return ``(done, fleet)`` — completions (rejected requests appear as
    ``Rejected`` wrappers in arrival position) plus the fleet for stats
    inspection. ``crash_at=k`` fail-stops ``crash_replica`` after the k-th
    submission — the fault-tolerance demo path."""
    fleet = Fleet(db, replicas=replicas, max_batch=max_batch,
                  max_wait_ms=max_wait_ms, max_inflight=max_inflight,
                  retry_timeout_s=retry_timeout_s, clock=clock, faults=faults,
                  collect_rows=collect_rows, kernel_policy=kernel_policy)
    done: List[object] = []
    for i, req in enumerate(requests):
        res = fleet.submit(req)
        if res is not None:
            done.append(res)
        done += fleet.take_completed()
        if crash_at is not None and i + 1 == crash_at:
            fleet.crash(crash_replica)
            done += fleet.take_completed()
        if arrival_gap_s and isinstance(fleet.transport.clock, SimClock):
            done += fleet.advance(arrival_gap_s)
    done += fleet.drain()
    return done, fleet
