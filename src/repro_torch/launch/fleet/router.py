"""The fleet router: admission control, fingerprint-affine routing, and
exact retry.

**Admission** is a bounded in-flight window: past ``max_inflight``
accepted-but-incomplete draws, ``submit`` returns an explicit ``Rejected``
— backpressure is a *response*, never a silent drop. (The seam where an
AGM/OUT-style output-size bound — Kim et al., arXiv 2304.00715 — would
set the window per query shape is ``Router.admit``; today it is a plain
count.)

**Routing** is affine on the query fingerprint: each shape hashes to a
home replica (stable across runs — md5, not the salted builtin ``hash``),
so each replica compiles only the shapes it homes — one plan-cache miss
per shape per replica, observable in the aggregated ``CacheStats``.

**Retry is exact, not at-least-once-approximate**: every accepted draw is
stamped with the log head version at admission, and a draw is a pure
function of (query, seed, version). When a replica crashes or a message
drops, the router re-sends the same stamped draw to a healthy replica and
gets the *bit-identical* result the lost serving would have produced.
Responses are deduplicated by request id (first one wins), and replicas
answer repeated ids from their served cache, so nothing is ever delivered
to the client twice.

**Updates** commit at the log append — the returned ``applied_version``
is ``base_version + lsn``. Replicas apply them later, at their own
version barriers; draws admitted after the update are stamped with the
new version and therefore observe it wherever they are served.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Dict, List, Optional

from repro_torch.engine import query_fingerprint

from .batcher import JoinSampleRequest, UpdateRequest
from .log import DeltaLog
from .replica import DOWN, DRAINING, Drain, DrainDone, Draw, DrawDone, UP
from .transport import Envelope, Transport

__all__ = ["Rejected", "Router"]


@dataclasses.dataclass
class Rejected:
    """An explicit backpressure response: the request was NOT admitted and
    will never complete — resubmit later or shed load."""

    request: object
    reason: str


@dataclasses.dataclass
class _RetryTimer:
    rid: int
    attempt: int


@dataclasses.dataclass
class _InFlight:
    req: JoinSampleRequest
    fingerprint: str
    version: int
    replica: str
    attempt: int = 1


class Router:
    def __init__(self, transport: Transport, log: DeltaLog,
                 replicas: List[str], *, name: str = "router",
                 max_inflight: int = 64, retry_timeout_s: float = 0.25):
        if not replicas:
            raise ValueError("router needs at least one replica")
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.name = name
        self.transport = transport
        self.log = log
        self.replicas = list(replicas)
        self.max_inflight = max_inflight
        self.retry_timeout_s = retry_timeout_s
        self.health: Dict[str, str] = {r: UP for r in replicas}
        self.inflight: Dict[int, _InFlight] = {}
        self.completed: List[object] = []
        self.drained: Dict[str, DrainDone] = {}
        self.accepted = 0
        self.rejected = 0
        self.retries = 0
        self.duplicates = 0
        self.updates = 0
        self._rid = itertools.count(1)
        transport.register(name, self.handle)
        transport.on_crash = self._on_replica_crash

    # -- admission -----------------------------------------------------------
    def admit(self, req: JoinSampleRequest) -> Optional[str]:
        """The admission-control policy seam: return a rejection reason or
        None to admit. Today: a bounded in-flight window."""
        if len(self.inflight) >= self.max_inflight:
            return (f"admission queue full "
                    f"({len(self.inflight)}/{self.max_inflight} in flight)")
        if not any(h == UP for h in self.health.values()):
            return "no healthy replicas"
        return None

    def submit(self, req) -> Optional[Rejected]:
        """Admit one request. Returns ``Rejected`` (with the reason) or
        None on acceptance; completions surface via ``take_completed``."""
        req.enqueued_s = self.transport.clock()
        if isinstance(req, UpdateRequest):
            lsn = self.log.append(req.delta)
            req.applied_version = self.log.base_version + lsn
            req.latency_s = self.transport.clock() - req.enqueued_s
            self.updates += 1
            self.completed.append(req)
            return None
        reason = self.admit(req)
        if reason is not None:
            self.rejected += 1
            return Rejected(req, reason)
        self.accepted += 1
        rid = next(self._rid)
        fp = query_fingerprint(req.query)
        fl = _InFlight(req, fp, self.log.head_version, self._route(fp))
        self.inflight[rid] = fl
        self._send(rid, fl)
        return None

    # -- routing -------------------------------------------------------------
    def _route(self, fingerprint: str) -> str:
        """The fingerprint's home replica, or the next healthy one ring-wise
        when the home is down/draining."""
        n = len(self.replicas)
        home = int(hashlib.md5(fingerprint.encode()).hexdigest(), 16) % n
        for i in range(n):
            cand = self.replicas[(home + i) % n]
            if self.health[cand] == UP:
                return cand
        raise RuntimeError("no healthy replicas to route to")

    def _send(self, rid: int, fl: _InFlight) -> None:
        self.transport.send(self.name, fl.replica,
                            Draw(rid, fl.req.query, fl.req.seed, fl.version))
        self.transport.call_later(self.name, self.retry_timeout_s,
                                  _RetryTimer(rid, fl.attempt))

    def _retry(self, rid: int, fl: _InFlight) -> None:
        self.retries += 1
        fl.attempt += 1
        fl.replica = self._route(fl.fingerprint)
        self._send(rid, fl)

    # -- mailbox -------------------------------------------------------------
    def handle(self, env: Envelope) -> None:
        msg = env.payload
        if isinstance(msg, DrawDone):
            fl = self.inflight.pop(msg.rid, None)
            if fl is None:
                self.duplicates += 1  # a retry raced the original; first won
                return
            if msg.db_version != fl.version:
                raise AssertionError(
                    f"rid {msg.rid}: served at version {msg.db_version}, "
                    f"stamped {fl.version} — the version barrier leaked")
            r = fl.req
            r.count = msg.count
            r.overflow = msg.overflow
            r.db_version = msg.db_version
            r.rows = msg.rows
            r.latency_s = self.transport.clock() - r.enqueued_s
            self.completed.append(r)
        elif isinstance(msg, _RetryTimer):
            fl = self.inflight.get(msg.rid)
            if fl is not None and fl.attempt == msg.attempt:
                self._retry(msg.rid, fl)
        elif isinstance(msg, DrainDone):
            self.drained[msg.replica] = msg
            self.health[msg.replica] = DOWN  # cleanly drained = out of rotation
        else:
            raise TypeError(f"router: unexpected message {msg!r}")

    def _on_replica_crash(self, name: str) -> None:
        if self.health.get(name) == DOWN:
            return
        self.health[name] = DOWN
        # Exact retry: every in-flight draw assigned to the dead replica is
        # re-sent, same stamp, to a healthy one.
        for rid, fl in list(self.inflight.items()):
            if fl.replica == name:
                self._retry(rid, fl)

    # -- lifecycle -----------------------------------------------------------
    def take_completed(self) -> List[object]:
        done, self.completed = self.completed, []
        return done

    def start_drain(self) -> None:
        """Tell every live replica to finish pending work, catch up to the
        log head, and stop. New submissions reject from here on."""
        for r in self.replicas:
            if self.health[r] == UP:
                self.health[r] = DRAINING
                self.transport.send(self.name, r, Drain())
