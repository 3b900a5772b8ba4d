"""The join-sampling service demo: single-engine micro-batching, or, with
``--replicas N``, a replicated fleet behind a router with log-shipped
deltas and an injected replica crash.

    python -m repro_torch.launch.serve --mode join [--replicas 4] [--updates 4]

The serving *library* lives in ``repro_torch.launch.fleet`` (router,
replica, transport, log, micro-batcher); this module is a thin demo over
it and re-exports the single-engine names (``MicroBatcher`` & co.). It
runs on the card; ``--device cpu`` runs it on the CPU.

Not ported: ``--mode lm`` and ``serve_batch`` (the model half, ROADMAP
A.7) and ``--devices`` (sharding, ROADMAP A.5); both refuse with a message.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np

from repro_torch.config import resolve_device
from repro_torch.launch.fleet import (  # noqa: F401  (re-exported public API)
    JoinSampleRequest, MicroBatcher, Rejected, UpdateRequest,
    serve_fleet, serve_join_samples,
)
from repro_torch.launch.metrics import percentile

__all__ = ["JoinSampleRequest", "MicroBatcher", "Rejected", "UpdateRequest",
           "serve_fleet", "serve_join_samples", "main"]

# The demo corpus: make_corpus_db's sizes in the reference's demo.
DEMO_CORPUS = dict(n_docs=20_000, n_clusters=64, seq_len=8, vocab=256)


def _demo_stream(db, n_requests: int, updates: int):
    """The shared demo workload: two tenant query shapes + optional
    shape-preserving doc churn spread through the stream."""
    from repro_torch.core import Atom, DeltaBatch, JoinQuery

    q_qual = JoinQuery((Atom.of("ClusterQuality", "clust", "p"),
                        Atom.of("Doc", "doc", "clust")), prob_var="p")
    q_flat = JoinQuery((Atom.of("ClusterQuality", "clust", "p"),),
                       prob_var="p")
    rng = np.random.default_rng(0)
    reqs: List = [JoinSampleRequest(query=q_qual if i % 3 else q_flat, seed=i)
                  for i in range(n_requests)]
    if updates:
        n_docs = int(db.relations["Doc"].num_rows)
        every = max(1, n_requests // updates)
        for u in range(updates):
            delta = DeltaBatch.of(Doc={
                "insert": {"doc": rng.integers(0, n_docs, 4),
                           "clust": rng.integers(0, 64, 4)},
                "delete": rng.choice(n_docs, size=4, replace=False)})
            reqs.insert(min((u + 1) * every + u, len(reqs)),
                        UpdateRequest(delta))
    return reqs, (q_qual, q_flat)


def _demo_db(device):
    from repro_torch.data.pipeline import make_corpus_db

    return make_corpus_db(**DEMO_CORPUS, device=device)


def _join_demo(n_requests: int, max_batch: int = 64,
               max_wait_ms: float = 2.0, updates: int = 0, *,
               device=None, kernel_policy=None) -> None:
    """Serve the demo stream through one engine's micro-batcher."""
    from repro_torch.engine import QueryEngine

    db = _demo_db(device)
    reqs, _ = _demo_stream(db, n_requests, updates)
    engine = QueryEngine(db, device=db.device, kernel_policy=kernel_policy)
    mb = MicroBatcher(engine, max_batch=max_batch, max_wait_ms=max_wait_ms)
    t0 = time.perf_counter()
    done: List = []
    for r in reqs:
        done += mb.submit(r)
        done += mb.poll()
    done += mb.flush()
    wall = time.perf_counter() - t0
    assert len(done) == n_requests + (updates or 0)
    draws = [r for r in done if isinstance(r, JoinSampleRequest)]
    lats = [r.latency_s * 1e3 for r in draws]
    st = engine.stats
    print(f"[serve-join] {n_requests} requests in {mb.flushes} flushes "
          f"({mb.dispatches} dispatches)  max_batch={max_batch} "
          f"max_wait={max_wait_ms}ms  device={engine.device}")
    print(f"  draws/sec={n_requests/wall:,.0f}  "
          f"latency p50={percentile(lats, .5):.1f}ms "
          f"p99={percentile(lats, .99):.1f}ms  "
          f"(incl. cold plan builds in early flushes)")
    print(f"  cache: shred_builds={st.shred_builds} shred_hits={st.shred_hits} "
          f"plan_hits={st.plan_hits} plan_misses={st.plan_misses}")
    if updates:
        print(f"  updates: applied={mb.updates_applied} "
              f"db_version={engine.db.version} "
              f"upgrades: shred={st.shred_upgrades} plan={st.plan_upgrades}")


def _fleet_demo(n_requests: int, replicas: int, max_batch: int = 64,
                max_wait_ms: float = 2.0, updates: int = 0,
                crash: bool = True, *, device=None,
                kernel_policy=None) -> None:
    """The replicated fleet demo: serve the same stream through
    ``replicas`` engine replicas, fail-stop one replica mid-stream, and
    check the results bit-identical to the single-engine micro-batcher
    baseline per (seed, version)."""
    from repro_torch.engine import QueryEngine

    db = _demo_db(device)
    reqs, _ = _demo_stream(db, n_requests, updates)
    crash_at = n_requests // 2 if crash and replicas > 1 else None

    t0 = time.perf_counter()
    done, fleet = serve_fleet(
        db, reqs, replicas=replicas, max_batch=max_batch,
        max_wait_ms=max_wait_ms, clock="real", retry_timeout_s=30.0,
        crash_at=crash_at, crash_replica=replicas - 1,
        kernel_policy=kernel_policy)
    wall = time.perf_counter() - t0

    draws = [r for r in done if isinstance(r, JoinSampleRequest)]
    rejected = [r for r in done if isinstance(r, Rejected)]
    assert len(draws) + len(rejected) == n_requests, \
        f"lost requests: {len(draws)}+{len(rejected)} != {n_requests}"
    assert len({id(r) for r in draws}) == len(draws), "request served twice"

    # Bit-identical to the single-engine baseline, per (seed, version).
    baseline = {}
    engine = QueryEngine(db, device=db.device, kernel_policy=kernel_policy)
    for r in serve_join_samples(engine,
                                _demo_stream(db, n_requests, updates)[0],
                                max_batch=max_batch):
        if isinstance(r, JoinSampleRequest):
            baseline[(r.seed, r.db_version)] = (r.count, r.overflow)
    mismatches = [r.seed for r in draws
                  if baseline.get((r.seed, r.db_version))
                  != (r.count, r.overflow)]
    assert not mismatches, f"fleet != single-engine for seeds {mismatches}"

    lats = [r.latency_s * 1e3 for r in draws]
    st = fleet.stats()
    rt = fleet.router
    crashed = [r.name for r in fleet.replicas
               if r.state == "down" and r.name not in rt.drained]
    print(f"[serve-fleet] {n_requests} requests over {replicas} replicas  "
          f"max_batch={max_batch} max_wait={max_wait_ms}ms  "
          f"crash_injected={crash_at is not None}  device={db.device}")
    print(f"  draws/sec={len(draws)/wall:,.0f}  "
          f"latency p50={percentile(lats, .5):.1f}ms "
          f"p99={percentile(lats, .99):.1f}ms  "
          f"rejected={len(rejected)} retries={rt.retries} "
          f"crashed_replicas={len(crashed)}")
    print(f"  fleet cache (aggregated): shred_builds={st.shred_builds} "
          f"plan_misses={st.plan_misses} plan_hits={st.plan_hits} "
          f"upgrades: shred={st.shred_upgrades} plan={st.plan_upgrades}")
    print(f"  log: head_lsn={fleet.log.head} "
          f"committed_version={fleet.db_version}  "
          f"results bit-identical to single-engine baseline: OK")


def main(argv: Optional[List[str]] = None, *, kernel_policy=None) -> int:
    """The CLI. ``kernel_policy`` (in-process callers only) is the
    engines' ``KernelPolicy``; ``None`` is the default."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("lm", "join"), default="join",
                    help="join: the join-sampling service; lm waits for "
                         "the model half (ROADMAP A.7)")
    ap.add_argument("--devices", type=int, default=1,
                    help="join mode: sharded serving waits for sharding "
                         "(ROADMAP A.5); only 1 is accepted")
    ap.add_argument("--replicas", type=int, default=1,
                    help="join mode: serve through a replicated fleet of "
                         "this many engine replicas")
    ap.add_argument("--requests", type=int, default=256,
                    help="join mode: number of requests in the demo stream")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="join mode: flush when this many requests are queued")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="join mode: flush when the oldest pending request "
                         "has waited this long")
    ap.add_argument("--updates", type=int, default=0,
                    help="join mode: interleave this many shape-preserving "
                         "update requests into the demo stream")
    ap.add_argument("--no-crash", action="store_true",
                    help="fleet mode: skip the injected mid-stream replica "
                         "crash")
    ap.add_argument("--device", default=None,
                    help="where the engines run (default: the card; 'cpu' "
                         "runs the plain versions)")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        ap.error("--mode lm is not ported: it waits for the model half "
                 "(ROADMAP A.7)")
    if args.devices != 1:
        ap.error("--devices is not ported: sharded serving waits for "
                 "sharding (ROADMAP A.5)")
    device = resolve_device(args.device)
    if args.replicas > 1:
        _fleet_demo(args.requests, args.replicas, max_batch=args.max_batch,
                    max_wait_ms=args.max_wait_ms, updates=args.updates,
                    crash=not args.no_crash, device=device,
                    kernel_policy=kernel_policy)
    else:
        _join_demo(args.requests, max_batch=args.max_batch,
                   max_wait_ms=args.max_wait_ms, updates=args.updates,
                   device=device, kernel_policy=kernel_policy)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
