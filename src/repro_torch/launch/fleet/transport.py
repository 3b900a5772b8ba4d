"""In-process deterministic transport for the replicated fleet.

The fleet's router and replicas never touch sockets: they exchange
messages through a ``Transport``, a discrete-event loop with

  * an **injectable clock** — ``SimClock`` (tests: time advances only when
    the caller advances it, so deadline flushes are reproducible) or any
    0-argument callable returning seconds (the demo/benchmark pass
    ``time.perf_counter`` for real latencies);
  * **total delivery order** — messages are delivered in
    ``(deliver_time, send_sequence)`` order, so two runs over the same
    arrival schedule and fault plan are bit-identical;
  * a **fault-injection hook** (``FaultInjector``) that can drop or delay
    individual messages and crash endpoints at named code points
    ("the 2nd delivery from router to replica1", "replica0's next flush"),
    again fully deterministically.

Endpoints register a handler; ``send`` enqueues, ``pump``/``advance``/
``run`` deliver. Delivery to a crashed endpoint silently drops (the wire
does not buffer for the dead) — crash *notification* is the monitor's
(router's) job via the ``on_crash`` callback.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["SimClock", "FaultInjector", "Envelope", "Transport",
           "DROP", "CRASH"]

DROP = "drop"
CRASH = "crash"


class SimClock:
    """A manually-advanced clock (seconds). ``Transport.advance``/``run``
    move it forward; nothing else does."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def __call__(self) -> float:
        return self.t


@dataclasses.dataclass
class _Rule:
    """One scheduled fault: fire ``action`` on the ``at``-th (1-based)
    occurrence of ``point``."""

    point: str
    action: object  # DROP | CRASH | ("delay", seconds)
    at: int = 1
    fired: bool = False


class FaultInjector:
    """A deterministic schedule of faults keyed by named code points.

    Points are plain strings; the fleet uses two families:

      * ``"deliver:<src>-><dst>"`` — consulted by ``Transport.send`` for
        every message on that edge (actions: ``DROP``, ``("delay", s)``,
        ``CRASH`` = crash the destination instead of delivering);
      * ``"<replica>:flush"`` / ``"<replica>:apply"`` — consulted by the
        replica before flushing a micro-batch / applying a log delta
        (action: ``CRASH``).

    ``inject(point, action, at=n)`` arms the n-th occurrence (1-based);
    occurrences are counted per point, so a plan like "drop the 3rd
    response from replica2" is one line in a test.
    """

    def __init__(self):
        self._rules: List[_Rule] = []
        self._counts: Dict[str, int] = {}

    def inject(self, point: str, action, *, at: int = 1) -> "FaultInjector":
        if isinstance(action, tuple):
            kind, delay = action
            if kind != "delay" or delay < 0:
                raise ValueError(f"bad fault action {action!r}")
        elif action not in (DROP, CRASH):
            raise ValueError(f"bad fault action {action!r}")
        self._rules.append(_Rule(point, action, at=at))
        return self

    def fire(self, point: str):
        """Count one occurrence of ``point``; return the armed action for
        this occurrence, or None."""
        n = self._counts.get(point, 0) + 1
        self._counts[point] = n
        for rule in self._rules:
            if rule.point == point and rule.at == n and not rule.fired:
                rule.fired = True
                return rule.action
        return None

    @property
    def pending(self) -> int:
        """Armed rules that have not fired yet (tests assert 0 at exit —
        a fault plan that never triggered is usually a test bug)."""
        return sum(1 for r in self._rules if not r.fired)


@dataclasses.dataclass
class Envelope:
    src: str
    dst: str
    payload: object
    send_t: float
    deliver_t: float
    seq: int


class Transport:
    """The in-process wire: named endpoints, ordered delivery, faults.

    ``clock`` may be a ``SimClock`` (default) or any callable -> seconds.
    With a ``SimClock``, ``advance(dt)`` moves time and delivers everything
    that comes due, in order; with a real clock, ``pump()`` delivers what
    is already due and ``run()`` drains regardless of wall time.
    """

    def __init__(self, *, clock: Optional[Callable[[], float]] = None,
                 faults: Optional[FaultInjector] = None):
        self.clock = clock if clock is not None else SimClock()
        self.faults = faults or FaultInjector()
        self._handlers: Dict[str, Callable[[Envelope], None]] = {}
        self._down: Dict[str, bool] = {}
        self._queue: List[Tuple[float, int, Envelope]] = []
        self._seq = itertools.count()
        self.on_crash: Optional[Callable[[str], None]] = None
        self.delivered = 0
        self.dropped = 0

    # -- endpoints -----------------------------------------------------------
    def register(self, name: str, handler: Callable[[Envelope], None]) -> None:
        if name in self._handlers:
            raise ValueError(f"endpoint {name!r} already registered")
        self._handlers[name] = handler
        self._down[name] = False

    def is_up(self, name: str) -> bool:
        return name in self._handlers and not self._down[name]

    def crash(self, name: str) -> None:
        """Mark an endpoint dead. Queued and future messages to it drop;
        the monitor (router) is told exactly once."""
        if self._down.get(name):
            return
        self._down[name] = True
        if self.on_crash is not None:
            self.on_crash(name)

    # -- sending -------------------------------------------------------------
    def send(self, src: str, dst: str, payload, *,
             delay: float = 0.0) -> None:
        """Enqueue ``payload`` for delivery ``delay`` seconds from now.
        The edge's fault point fires here (send time), so a drop costs the
        wire nothing and a delay is added on top of ``delay``."""
        now = self.clock()
        action = self.faults.fire(f"deliver:{src}->{dst}")
        if action == DROP:
            self.dropped += 1
            return
        if action == CRASH:
            self.dropped += 1
            self.crash(dst)
            return
        if isinstance(action, tuple):  # ("delay", seconds)
            delay += action[1]
        env = Envelope(src, dst, payload, now, now + delay, next(self._seq))
        heapq.heappush(self._queue, (env.deliver_t, env.seq, env))

    def call_later(self, dst: str, dt: float, payload) -> None:
        """A timer: the endpoint sends itself a message ``dt`` seconds out.
        Timers bypass fault points — they model local clocks, not wires."""
        now = self.clock()
        env = Envelope(dst, dst, payload, now, now + dt, next(self._seq))
        heapq.heappush(self._queue, (env.deliver_t, env.seq, env))

    # -- delivery ------------------------------------------------------------
    def _deliver(self, env: Envelope) -> None:
        if self._down.get(env.dst, True):
            self.dropped += 1  # the dead do not receive
            return
        self.delivered += 1
        self._handlers[env.dst](env)

    def pump(self) -> int:
        """Deliver everything already due (``deliver_t <= now``) in order.
        Returns the number of messages delivered."""
        n = 0
        while self._queue and self._queue[0][0] <= self.clock():
            _, _, env = heapq.heappop(self._queue)
            self._deliver(env)
            n += 1
        return n

    def advance(self, dt: float) -> int:
        """SimClock only: move time forward by ``dt``, delivering due
        messages at their own timestamps along the way."""
        if not isinstance(self.clock, SimClock):
            raise TypeError("advance() needs a SimClock; real clocks move "
                            "on their own — use pump()/run()")
        target = self.clock.t + dt
        n = 0
        while self._queue and self._queue[0][0] <= target:
            self.clock.t = max(self.clock.t, self._queue[0][0])
            n += self.pump()
        self.clock.t = target
        return n

    def run(self) -> int:
        """Drain the queue completely (delivery may enqueue more; keep
        going until quiet). With a ``SimClock``, time jumps to each
        message's deliver_t; with a real clock, late messages deliver
        immediately — draining never busy-waits."""
        n = 0
        while self._queue:
            deliver_t, _, _ = self._queue[0]
            if isinstance(self.clock, SimClock):
                self.clock.t = max(self.clock.t, deliver_t)
            _, _, env = heapq.heappop(self._queue)
            self._deliver(env)
            n += 1
        return n

    @property
    def queued(self) -> int:
        return len(self._queue)
