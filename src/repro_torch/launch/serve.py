"""Serving demos: (1) LM batched prefill + decode (``serve_batch``,
``--mode lm``), and (2) the join-sampling service: single-engine
micro-batching (with ``--devices N``, through the engine's sharded plan
over a mesh of N entries), or, with ``--replicas N``, a replicated fleet
behind a router with log-shipped deltas and an injected replica crash.

    python -m repro_torch.launch.serve --mode lm [--full] [--arch smollm_135m]
    python -m repro_torch.launch.serve --mode lm --device cpu
    python -m repro_torch.launch.serve --mode join [--devices 4]
    python -m repro_torch.launch.serve --mode join --replicas 4 [--updates 4]

The serving *library* lives in ``repro_torch.launch.fleet`` (router,
replica, transport, log, micro-batcher); this module is a thin demo over
it and re-exports the single-engine names (``MicroBatcher`` & co.). It
runs on the card (a mesh round-robin over the visible cards);
``--device cpu`` runs it on the CPU.

``--mode lm`` serves the reduced config of ``--arch`` (head dim 16, float32:
the float32 attention kernels' D 16 instances on the card), as the
reference's default does, or, with ``--full``, the published one, from
random weights drawn from a seed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.config import resolve_device
from repro_torch.kernels import flash_decode, flash_prefill
from repro_torch.launch.fleet import (  # noqa: F401  (re-exported public API)
    JoinSampleRequest, MicroBatcher, Rejected, UpdateRequest,
    serve_fleet, serve_join_samples,
)
from repro_torch.launch.metrics import percentile
from repro_torch.models import (Transformer, decode_step, encode, init_model,
                                prefill)

__all__ = ["Request", "batch_memory", "serve_batch", "JoinSampleRequest",
           "MicroBatcher", "Rejected", "UpdateRequest", "serve_fleet",
           "serve_join_samples", "main"]


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new: int = 16
    out: Optional[List[int]] = None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def batch_memory(params: Transformer, batch: int,
                 frames: Optional[torch.Tensor] = None
                 ) -> Optional[torch.Tensor]:
    """The memory a batch of ``batch`` requests attends to, as the
    reference serves it: a cross-attention model's ``n_memory_tokens``
    zero tokens (B, M, d); an encoder model's encoder over ``frames`` (zero
    frames (B, M, enc_d) when ``None``); ``None`` for the others."""
    cfg, dev = params.cfg, params.device
    if cfg.has_encoder:
        if frames is None:
            frames = torch.zeros((batch, cfg.n_memory_tokens,
                                  cfg.enc_d_model), device=dev)
        return encode(params, frames)
    if cfg.n_memory_tokens:
        return torch.zeros((batch, cfg.n_memory_tokens, cfg.d_model),
                           device=dev)
    return None


@torch.no_grad()
def serve_batch(arch: str, requests: List[Request], seed: int = 0,
                greedy: bool = True, *, reduced: bool = True,
                params: Optional[Transformer] = None, device=None,
                stats: Optional[Dict] = None) -> List[Request]:
    """Pad requests to one batch, prefill, then decode greedily in
    lockstep; each request's ``out`` gets its first ``max_new`` tokens.

    ``reduced`` serves ``configs.reduced`` of ``arch`` (the reference's
    default); ``False`` serves the published config. ``params`` is the
    model to serve (e.g. from ``params_from_reference``; it carries its
    ``KernelPolicy``); without it one is drawn from ``seed`` on ``device``
    (the card by default). As in the reference, decoding starts by feeding
    the last prompt column again, at position S (for a shorter prompt that
    is its pad, 0), and pad positions are not masked.

    ``stats``, when a dict, gets the host milliseconds of the prefill and
    of each decode step (each ended by a device synchronize) and the
    batch's shape."""
    if not greedy:
        raise ValueError("serve_batch decodes greedily (greedy=True)")
    if params is None:
        cfg = configs.get_config(arch)
        if reduced:
            cfg = configs.reduced(cfg)
        params = init_model(cfg, seed, device=device)
    cfg, dev = params.cfg, params.device
    B = len(requests)
    S = max(len(r.prompt) for r in requests)
    max_new = max(r.max_new for r in requests)
    total = S + max_new + 1
    toks = torch.zeros((B, S), dtype=torch.long)
    for i, r in enumerate(requests):
        toks[i, :len(r.prompt)] = torch.as_tensor(r.prompt, dtype=torch.long)
    toks = toks.to(dev)

    mem = batch_memory(params, B)

    timed = stats is not None
    if timed:
        _sync(dev)
        t0 = time.perf_counter()
    _, cache = prefill(params, toks, total, mem)
    if timed:
        _sync(dev)
        stats.update(batch=B, prompt_len=S, max_new=max_new, cache_len=total,
                     prefill_ms=(time.perf_counter() - t0) * 1e3,
                     decode_ms=[])
    cur_tok = toks[:, -1:]
    steps = []
    for t in range(max_new):
        if timed:
            t0 = time.perf_counter()
        logits, cache = decode_step(params, cache, cur_tok, S + t)
        cur_tok = torch.argmax(logits[:, -1], dim=-1, keepdim=True)
        steps.append(cur_tok)
        if timed:
            _sync(dev)
            stats["decode_ms"].append((time.perf_counter() - t0) * 1e3)
    outs = torch.cat(steps, dim=1).tolist() if steps else [[] for _ in requests]
    for r, o in zip(requests, outs):
        r.out = o[:r.max_new]
    return requests


def _lm_demo(arch: str, batch: int, max_new: int, full: bool,
             device) -> None:
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(1, 200, rng.integers(4, 12)).tolist(),
                    max_new=max_new) for _ in range(batch)]
    stats: Dict = {}
    t0 = time.time()
    done = serve_batch(arch, reqs, reduced=not full, device=device,
                       stats=stats)
    dt = time.time() - t0
    ntok = sum(len(r.out) for r in done)
    decode = stats["decode_ms"]
    print(f"[serve] {arch}{'' if full else ' (reduced)'} on {device}: "
          f"{len(done)} requests, {ntok} tokens in {dt:.2f}s ({ntok / dt:.1f} "
          f"tok/s batched, model init included); prefill "
          f"{stats['prefill_ms']:.2f} ms, decode step "
          f"{sum(decode) / max(len(decode), 1):.2f} ms")
    for i, r in enumerate(done):
        print(f"  req{i}: prompt[:4]={r.prompt[:4]} -> out[:8]={r.out[:8]}")
    # the attention kernels' launches in this process, by instance (0 on
    # the CPU, where the plain versions run)
    print("[serve] kernels " + json.dumps(
        {"decode_steps": len(decode),
         **{f.__name__: {"launches": f.launches, "instances": f.tiles}
            for f in (flash_prefill.flash_prefill,
                      flash_decode.flash_decode)}}))

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


def _join_demo(n_requests: int, devices: int = 1, max_batch: int = 64,
               max_wait_ms: float = 2.0, updates: int = 0, *,
               device=None, kernel_policy=None) -> None:
    """Serve the demo stream through one engine's micro-batcher; with
    ``devices > 1`` through its sharded plan over a mesh of that many
    entries: round-robin over the visible cards when ``device`` is a
    card, else every entry on ``device``."""
    from repro_torch.engine import QueryEngine, ShardedPlan
    from repro_torch.launch.mesh import make_mesh

    mesh = None
    if devices > 1:
        on_card = device is None or torch.device(device).type == "cuda"
        mesh = make_mesh((devices,), ("data",),
                         devices=None if on_card else device)
    db = _demo_db(device)
    reqs, (q_qual, _) = _demo_stream(db, n_requests, updates)
    engine = QueryEngine(db, device=db.device, kernel_policy=kernel_policy)
    mb = MicroBatcher(engine, max_batch=max_batch, max_wait_ms=max_wait_ms,
                      mesh=mesh)
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
    shards = ""
    if mesh is not None:  # the planner may fall back to the single plan
        plan = engine.compile_sharded(q_qual, mesh)
        shards = (f"  shards={plan.num_shards}"
                  if isinstance(plan, ShardedPlan) else "  shards=1")
    print(f"[serve-join] {n_requests} requests in {mb.flushes} flushes "
          f"({mb.dispatches} dispatches){shards}  max_batch={max_batch} "
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
                    help="join: the join-sampling service; lm: batched "
                         "prefill + greedy decode of a model")
    ap.add_argument("--arch", default="smollm_135m",
                    help=f"lm mode: one of {', '.join(configs.ARCHS)}")
    ap.add_argument("--batch", type=int, default=4,
                    help="lm mode: requests in the batch")
    ap.add_argument("--max-new", type=int, default=12,
                    help="lm mode: new tokens a request")
    ap.add_argument("--full", action="store_true",
                    help="lm mode: serve the published config, not the "
                         "reduced one")
    ap.add_argument("--devices", type=int, default=1,
                    help="join mode: serve through the engine's sharded "
                         "plan over a mesh of this many entries")
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
                    help="where it runs (default: the card; 'cpu' runs the "
                         "plain versions)")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        if args.batch < 1 or args.max_new < 1:
            ap.error(f"--batch and --max-new must be >= 1, got {args.batch} "
                     f"and {args.max_new}")
        if args.arch not in configs.ARCHS and args.arch not in configs.ALIASES:
            ap.error(f"--arch must be one of {', '.join(configs.ARCHS)}")
        _lm_demo(args.arch, args.batch, args.max_new, args.full,
                 resolve_device(args.device))
        return 0
    if args.devices < 1:
        ap.error(f"--devices must be >= 1, got {args.devices}")
    device = resolve_device(args.device)
    if args.replicas > 1:
        _fleet_demo(args.requests, args.replicas, max_batch=args.max_batch,
                    max_wait_ms=args.max_wait_ms, updates=args.updates,
                    crash=not args.no_crash, device=device,
                    kernel_policy=kernel_policy)
    else:
        _join_demo(args.requests, devices=args.devices,
                   max_batch=args.max_batch,
                   max_wait_ms=args.max_wait_ms, updates=args.updates,
                   device=device, kernel_policy=kernel_policy)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
