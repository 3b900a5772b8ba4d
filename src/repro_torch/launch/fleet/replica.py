"""A fleet replica: one ``QueryEngine`` + ``MicroBatcher`` behind a
transport mailbox.

Every replica starts from the same base snapshot and consumes the shared
``DeltaLog`` independently. Deltas are applied **at version barriers**:
when a draw stamped with a version ahead of the replica's snapshot
arrives (or at drain), the replica first flushes its pending micro-batch
— those draws read the old snapshot, exactly like the single-engine
update barrier — then replays log entries in LSN order.
Because application order is the log order everywhere, every replica's
snapshot sequence is bit-identical to ``Database.apply``-ing the log on
one engine.

Draws are *pure* given (query, seed, version): the replica keeps its
snapshot history, so a draw stamped with an **older** version (delayed or
retried after the replica advanced) is served from the historical
snapshot — the result is still exactly the stamped version's, never an
approximation. Served responses are cached by request id, so a retried
draw whose response was dropped is answered idempotently, not recomputed
into a second serving.

Health states: ``up`` (serving), ``draining`` (finish pending + catch up
to the log head, then stop), ``down`` (crashed, or drained). A crash
clears the pending micro-batch — the router's retry logic (exact, thanks
to purity) is what makes that loss invisible to clients.

Every engine a replica makes (its own, and the engines of older
snapshots) lives on the database's device under the fleet's
``KernelPolicy``; on one card every replica's snapshots share its memory.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.engine import QueryEngine
from repro_torch.kernels import threefry

from .batcher import JoinSampleRequest, MicroBatcher
from .log import DeltaLog
from .transport import CRASH, Envelope, Transport

__all__ = ["Draw", "DrawDone", "Drain", "DrainDone", "FlushTimer",
           "Replica", "UP", "DRAINING", "DOWN"]

UP, DRAINING, DOWN = "up", "draining", "down"


# -- wire messages -----------------------------------------------------------

@dataclasses.dataclass
class Draw:
    """Router -> replica: serve one Poisson draw at exactly ``version``."""

    rid: int
    query: object
    seed: int
    version: int


@dataclasses.dataclass
class DrawDone:
    """Replica -> router: the draw's result. ``db_version`` echoes the
    snapshot actually read — the router asserts it equals the stamp."""

    rid: int
    count: int
    overflow: bool
    db_version: int
    replica: str
    rows: Optional[Dict[str, np.ndarray]] = None


@dataclasses.dataclass
class Drain:
    """Router -> replica: finish pending work, catch up to the log head,
    then stop accepting draws."""


@dataclasses.dataclass
class DrainDone:
    replica: str
    db_version: int
    stats: object  # engine CacheStats snapshot


@dataclasses.dataclass
class FlushTimer:
    """Self-timer armed when the queue goes non-empty: fires the deadline
    flush at exactly enqueue + max_wait_ms (reproducible under SimClock)."""


@dataclasses.dataclass
class _Draw(JoinSampleRequest):
    """A micro-batcher request carrying its fleet request id."""

    rid: int = -1


class Replica:
    def __init__(self, name: str, db, log: DeltaLog, transport: Transport,
                 *, router: str = "router", max_batch: int = 8,
                 max_wait_ms: float = 2.0, collect_rows: bool = False,
                 max_stale_engines: int = 4, kernel_policy=None):
        self.name = name
        self.log = log
        self.transport = transport
        self.router = router
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.collect_rows = collect_rows
        self.state = UP
        self.kernel_policy = kernel_policy
        self.engine = self._engine(db)
        # The batcher never self-flushes on size: the replica owns both
        # triggers so every flush passes the "<name>:flush" fault point.
        self.batcher = MicroBatcher(
            self.engine, max_batch=1 << 30, max_wait_ms=max_wait_ms,
            clock=transport.clock, collect_rows=collect_rows)
        # version -> snapshot, for exact service of older-stamped draws.
        self.snapshots: Dict[int, object] = {db.version: db}
        self._stale_engines: "collections.OrderedDict[int, QueryEngine]" = \
            collections.OrderedDict()
        self._max_stale = max_stale_engines
        self.served: Dict[int, DrawDone] = {}
        self.duplicates = 0
        self.stale_serves = 0
        transport.register(name, self.handle)

    def _engine(self, db) -> QueryEngine:
        """An engine on ``db``'s own device under the fleet's policy."""
        return QueryEngine(db, device=db.device,
                           kernel_policy=self.kernel_policy)

    # -- mailbox -------------------------------------------------------------
    def handle(self, env: Envelope) -> None:
        msg = env.payload
        if isinstance(msg, Draw):
            self._on_draw(msg)
        elif isinstance(msg, FlushTimer):
            self._on_timer()
        elif isinstance(msg, Drain):
            self._on_drain()
        else:
            raise TypeError(f"{self.name}: unexpected message {msg!r}")

    def _on_draw(self, msg: Draw) -> None:
        cached = self.served.get(msg.rid)
        if cached is not None:
            # Idempotent retry: the draw was already served (its response
            # was dropped, or the router timed out early) — resend the
            # cached result instead of serving twice.
            self.duplicates += 1
            self.transport.send(self.name, self.router, cached)
            return
        if self.state != UP:
            return  # draining/down replicas take no new work; retry covers it
        if msg.version > self.engine.db.version:
            if not self._catch_up(msg.version):
                return  # crashed at the barrier
        if msg.version < self.engine.db.version:
            self._serve_stale(msg)
            return
        req = _Draw(query=msg.query, seed=msg.seed, rid=msg.rid)
        if len(self.batcher.pending) + 1 >= self.max_batch:
            self.batcher.submit(req)
            self._respond_all(self._flush())
        else:
            self.batcher.submit(req)
            if len(self.batcher.pending) == 1:
                self.transport.call_later(self.name, self.max_wait_ms * 1e-3,
                                          FlushTimer())

    def _on_timer(self) -> None:
        if self.state != UP or not self.batcher.pending:
            return
        waited_ms = (self.transport.clock()
                     - self.batcher.pending[0].enqueued_s) * 1e3
        if waited_ms >= self.max_wait_ms - 1e-9:
            self._respond_all(self._flush())
        else:
            # The guarded request flushed already; a younger one now heads
            # the queue. Re-arm for its remaining wait.
            self.transport.call_later(
                self.name, self.max_wait_ms * 1e-3 - waited_ms * 1e-3,
                FlushTimer())

    def _on_drain(self) -> None:
        if self.state != UP:
            return
        self.state = DRAINING
        self._respond_all(self._flush())
        if self.state == DOWN:
            return  # crashed mid-drain; the router's retries take over
        self._catch_up(self.log.head_version)
        if self.state == DOWN:
            return
        self.state = DOWN  # cleanly drained
        self.transport.send(self.name, self.router, DrainDone(
            self.name, self.engine.db.version, self.engine.stats.snapshot()))

    # -- serving -------------------------------------------------------------
    def _flush(self):
        """Every flush passes the fault point — "crash mid-flush" loses the
        whole pending batch, which is exactly what retry must survive."""
        if self.state == DOWN:
            return []
        if self.transport.faults.fire(f"{self.name}:flush") == CRASH:
            self.crash()
            return []
        return self.batcher.flush()

    def _catch_up(self, version: int) -> bool:
        """The version barrier: drain pending draws on the current
        snapshot, then replay log entries up to ``version`` in LSN order,
        recording every intermediate snapshot."""
        self._respond_all(self._flush())
        if self.state == DOWN:
            return False
        cur = self.log.version_to_lsn(self.engine.db.version)
        for delta in self.log.read(cur, self.log.version_to_lsn(version)):
            if self.transport.faults.fire(f"{self.name}:apply") == CRASH:
                self.crash()
                return False
            self.engine.apply_delta(delta)
            self.snapshots[self.engine.db.version] = self.engine.db
        return True

    def _serve_stale(self, msg: Draw) -> None:
        """Serve a draw stamped with a version this replica has already
        moved past — from the historical snapshot, so the result is
        bit-identical to what a replica still at that version returns."""
        db = self.snapshots.get(msg.version)
        if db is None:
            raise KeyError(f"{self.name}: no snapshot for version "
                           f"{msg.version} (have {sorted(self.snapshots)})")
        eng = self._stale_engines.get(msg.version)
        if eng is None:
            eng = self._engine(db)
            self._stale_engines[msg.version] = eng
            while len(self._stale_engines) > self._max_stale:
                self._stale_engines.popitem(last=False)
        else:
            self._stale_engines.move_to_end(msg.version)
        smp = eng.sample(msg.query, threefry.key(msg.seed))
        self.stale_serves += 1
        count = int(smp.count)
        rows = None
        if self.collect_rows:
            rows = {c: v[:count].cpu().numpy()
                    for c, v in smp.columns.items()}
        resp = DrawDone(msg.rid, count, bool(smp.overflow), msg.version,
                        self.name, rows=rows)
        self.served[msg.rid] = resp
        self.transport.send(self.name, self.router, resp)

    def _respond_all(self, done) -> None:
        for r in done:
            resp = DrawDone(r.rid, r.count, r.overflow, r.db_version,
                            self.name, rows=r.rows)
            self.served[r.rid] = resp
            self.transport.send(self.name, self.router, resp)

    def crash(self) -> None:
        """Fail-stop: pending draws are lost (never half-served), queued
        messages to this replica drop, and the transport tells the
        monitor (router) exactly once."""
        self.state = DOWN
        self.batcher.pending.clear()
        self.transport.crash(self.name)
