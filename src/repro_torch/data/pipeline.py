"""Training-data pipeline built on Poisson sampling over acyclic joins.

The corpus is a relational database — e.g.

    Doc(doc, clust)                 one row per document
    ClusterQuality(clust, p)        data-curation probability per cluster

and each training step draws an independent Poisson sample of the join
``beta_p(Doc |><| ClusterQuality)``: quality-weighted data selection with
fresh randomness every step, without materializing the joined corpus. The
shredded index is built once; a step costs O(k log |db|).

The source is engine-native: draws go through ``QueryEngine.sample_batch``
— a *window* of W consecutive steps is one batched dispatch (one launch
of the batched draw kernel on the fused and paged routes) — and token
rows are gathered on the device, so the steady path reads nothing back to
the host per step. The corpus is *live*: ``DeltaBatch`` events scheduled
at step barriers advance the engine via ``apply_delta`` (warm caches
upgraded in place), prefetch windows are clipped at the barriers so no
window straddles two snapshots, and every batch records the
``db_version`` it was drawn at.

Determinism/resume: batch(step) depends only on (seed, step, schedule) —
per-step keys are ``threefry.fold_in(key(seed), step)`` (the words of
``jax.random.fold_in``), window boundaries are a pure function of the
step and the (static) delta schedule, and lane ``b`` of a batched draw
equals the single draw under ``keys[b]`` — so a restart resumes
mid-epoch exactly (a checkpoint stores the step counter and the data
version).

Not ported: ``SyntheticLMSource``, which feeds only the model trainer
(ROADMAP A.7).
"""
from __future__ import annotations

import bisect
import dataclasses
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import Atom, Database, DeltaBatch, JoinQuery
from repro_torch.engine import DrawSpec, QueryEngine
from repro_torch.kernels import threefry

__all__ = ["make_corpus_db", "corpus_delta", "PoissonJoinSource",
           "Prefetcher"]


def make_corpus_db(
    n_docs: int,
    n_clusters: int,
    seq_len: int,
    vocab: int,
    seed: int = 0,
    mean_quality: float = 0.3,
    device=None,
) -> Database:
    """A synthetic relational corpus: documents with cluster-level quality
    scores (stand-in for dedup/quality pipelines), generated by numpy
    exactly as the reference generates it. ``device=None`` is the card."""
    rng = np.random.default_rng(seed)
    return Database.from_columns({
        "Doc": {
            "doc": np.arange(n_docs),
            "clust": rng.integers(0, n_clusters, n_docs),
        },
        "ClusterQuality": {
            "clust": np.arange(n_clusters),
            "p": np.clip(rng.beta(2, 2 / mean_quality - 2, n_clusters), 0, 1),
        },
        # token payloads live beside the relations (column-store style)
        "_tokens": {"flat": rng.integers(0, vocab, n_docs * seq_len)},
    }, device=device)


def corpus_delta(db: Database, seq_len: int, vocab: int, *,
                 insert: int = 0, retire: Sequence[int] = (),
                 seed: int = 0) -> DeltaBatch:
    """A live-corpus change set against ``db``: ``insert`` fresh documents
    and/or ``retire`` existing ``Doc`` rows (row indices into the current
    snapshot).

    The doc-id = token-row invariant is preserved the cheap way: retiring a
    document deletes its ``Doc`` row only (its token row is orphaned, never
    re-indexed — surviving doc ids stay valid), while inserts append to
    both ``Doc`` and ``_tokens`` with ids continuing the token-row count.
    """
    if not insert and not len(retire):
        raise ValueError("corpus_delta: nothing to insert or retire")
    rng = np.random.default_rng(seed)
    n_tok_rows = db.relations["_tokens"].column("flat").shape[0] // seq_len
    n_clusters = db.relations["ClusterQuality"].num_rows
    per_rel: Dict[str, dict] = {}
    doc_spec: Dict[str, object] = {}
    if len(retire):
        doc_spec["delete"] = np.asarray(retire, np.int64)
    if insert:
        doc_spec["insert"] = {
            "doc": n_tok_rows + np.arange(insert),
            "clust": rng.integers(0, n_clusters, insert),
        }
        per_rel["_tokens"] = {
            "insert": {"flat": rng.integers(0, vocab, insert * seq_len)},
        }
    per_rel["Doc"] = doc_spec
    return DeltaBatch.of(**per_rel)


@dataclasses.dataclass
class _Window:
    """One prefetched dispatch: W consecutive steps of one snapshot,
    resident on the device. ``lanes[step - start]`` serves
    ``batch_at(step)``: the window's gather made every lane's views
    (tokens, targets, doc_ids, count), so a served step is a tuple
    lookup."""

    start: int
    end: int
    version: int
    lanes: Tuple            # W x (tokens, targets, doc_ids, count)
    wrapped: torch.Tensor   # (W,) bool: draw undershot the batch size


class PoissonJoinSource:
    """Batches of token sequences selected by Poisson sampling over a join,
    drawn through ``QueryEngine.sample_batch``.

    Each step: take lane ``step - start`` of the step's prefetch window —
    one batched engine dispatch per ``window`` steps — wrap the sampled doc
    ids deterministically if the draw undershot ``batch`` (counted in
    ``wrapped``, never silent), and gather token rows on the device.

    ``deltas`` is a step-aligned schedule of ``(step, DeltaBatch)`` events:
    the batch at ``step`` (and every later one) is drawn at the post-delta
    snapshot, applied via ``engine.apply_delta`` so warm caches upgrade in
    place. Windows are clipped at the barriers — no window straddles two
    versions — and every batch carries the ``db_version`` it was drawn at.
    Steps must be consumed in non-decreasing version order (the engine
    moves forward); a fresh source replays the schedule from the base
    snapshot, which is what makes kill/resume bit-exact.

    Given a ``Database``, the source builds its engine on the database's
    device under ``kernel_policy``.
    """

    def __init__(self, db: Optional[Database], seq_len: int, batch: int,
                 seed: int = 0, query: Optional[JoinQuery] = None,
                 doc_var: str = "doc", engine: Optional[QueryEngine] = None,
                 window: int = 8, depth: int = 2,
                 deltas: Sequence[Tuple[int, DeltaBatch]] = (),
                 spec: Optional[DrawSpec] = None, kernel_policy=None):
        if engine is None:
            if db is None:
                raise ValueError("pass a Database or a QueryEngine")
            engine = QueryEngine(db, device=db.device,
                                 kernel_policy=kernel_policy)
        self.engine = engine
        self.query = query or JoinQuery(
            (Atom.of("ClusterQuality", "clust", "p"),
             Atom.of("Doc", "doc", "clust")),
            prob_var="p")
        self.seq_len = seq_len
        self.batch = batch
        self.doc_var = doc_var
        self.seed = seed
        self.key = threefry.key(seed)
        self.window = int(window)
        if self.window < 1:
            raise ValueError("window must be >= 1")
        self._depth = max(int(depth), 1)
        self._ring: Dict[int, _Window] = {}

        # Delta schedule: sorted events; version_at(step) = base + #{e <= step}.
        self._events: List[Tuple[int, DeltaBatch]] = sorted(
            ((int(s), d) for s, d in deltas), key=lambda e: e[0])
        self._event_steps = [s for s, _ in self._events]
        self._applied = 0
        self.base_version = self.engine.db.version

        # Capacity is resolved ONCE at construction and frozen into the
        # spec: a resumed source re-deriving it from a later snapshot would
        # change batch contents. The 128-row rounding is the reference's;
        # a draw that still undershoots ``batch`` wraps deterministically
        # and increments ``wrapped`` rather than wrapping silently.
        plan = self.engine.compile(self.query, spec)
        base = spec or DrawSpec()
        cap = base.cap or plan.default_capacity()
        self.cap = max(cap, ((batch + 127) // 128) * 128)
        self._spec = base.with_overrides(cap=self.cap)
        self._bind_tokens()

        # Telemetry without steady-path host reads: overflow accumulates
        # on the device once per window; wrap flags are kept per served
        # lane as (device tensor, lane) references and read when the
        # ``wrapped`` property is.
        self._wrapped_host = 0
        self._served_wrapped: List[Tuple[torch.Tensor, int]] = []
        self._overflow_dev = torch.zeros((), dtype=torch.int64,
                                         device=self.engine.device)

    # -- live-corpus schedule ------------------------------------------------
    def _bind_tokens(self) -> None:
        flat = self.engine.db.relations["_tokens"].column("flat")
        if flat.shape[0] % self.seq_len:
            raise ValueError("_tokens length is not a multiple of seq_len")
        self.tokens = flat.reshape(-1, self.seq_len)

    def version_at(self, step: int) -> int:
        """The snapshot version the batch at ``step`` is drawn at — a pure
        function of the schedule (the resume contract's second half)."""
        return self.base_version + bisect.bisect_right(self._event_steps, step)

    def _advance_to(self, step: int) -> None:
        """Apply every scheduled delta with event step <= ``step``."""
        want = bisect.bisect_right(self._event_steps, step)
        if want < self._applied:
            raise ValueError(
                f"source already advanced past step {step} (version "
                f"{self.base_version + self._applied} > "
                f"{self.version_at(step)}); build a fresh source to rewind")
        while self._applied < want:
            _, delta = self._events[self._applied]
            self.engine.apply_delta(delta)
            self._applied += 1
            self._bind_tokens()

    def _window_bounds(self, step: int) -> Tuple[int, int]:
        """The prefetch window containing ``step``: the aligned ``window``
        grid, clipped at delta barriers so one window = one snapshot."""
        s0 = (step // self.window) * self.window
        end = s0 + self.window
        i = bisect.bisect_right(self._event_steps, step)
        if i > 0:
            s0 = max(s0, self._event_steps[i - 1])
        if i < len(self._event_steps):
            end = min(end, self._event_steps[i])
        return s0, end

    # -- draw path -----------------------------------------------------------
    def _gather(self, docs: torch.Tensor, counts: torch.Tensor):
        """docs (W, cap), counts (W,) -> per-lane wrap and token gather,
        all on the device: lane i takes sampled docs ``arange(batch) %
        count`` and their token rows."""
        cnt = counts.clamp(1, docs.shape[1]).unsqueeze(1)
        idx = torch.arange(self.batch, device=docs.device).unsqueeze(0) % cnt
        chosen = torch.gather(docs, 1, idx)                 # (W, batch)
        toks = self.tokens[chosen].to(torch.int32)          # (W, batch, S)
        wrapped = counts < self.batch
        lanes = tuple((toks[i, :, :-1], toks[i, :, 1:], chosen[i], counts[i])
                      for i in range(counts.shape[0]))
        return lanes, wrapped

    def _dispatch(self, s0: int, end: int) -> _Window:
        self._advance_to(s0)
        keys = threefry.fold_in_batch(self.key, range(s0, end))
        smp = self.engine.sample_batch(self.query, keys, self._spec)
        lanes, wrapped = self._gather(smp.columns[self.doc_var], smp.count)
        self._overflow_dev += smp.overflow.sum()
        win = _Window(s0, end, self.engine.db.version, lanes, wrapped)
        self._ring[s0] = win
        return win

    def _window_for(self, step: int) -> _Window:
        s0, end = self._window_bounds(step)
        for k in [k for k, w in self._ring.items() if w.end <= step]:
            del self._ring[k]
        win = self._ring.get(s0)
        if win is None:
            win = self._dispatch(s0, end)
        # Eagerly dispatch the next window: the ring's second slot. The
        # device fills it while the host trains on the current one, as far
        # as the draw's route issues no host sync.
        if self._depth > 1 and len(self._ring) < self._depth:
            n0, nend = self._window_bounds(end)
            if n0 not in self._ring:
                self._dispatch(n0, nend)
        return win

    def batch_at(self, step: int) -> Dict[str, object]:
        """Deterministic in (seed, step, schedule) — the resume contract.
        ``db_version`` is a host int (checkpoint metadata); everything else
        stays on the device."""
        win = self._window_for(step)
        toks, targets, docs, count = win.lanes[step - win.start]
        self._served_wrapped.append((win.wrapped, step - win.start))
        return {
            "tokens": toks,
            "targets": targets,
            "sampled_k": count,
            "doc_ids": docs,
            "db_version": win.version,
        }

    # -- telemetry -----------------------------------------------------------
    @property
    def wrapped(self) -> int:
        """Served batches whose draw undershot ``batch`` (doc ids repeated
        by deterministic wrap). Reading it reads the kept flags to the host
        (the only host read on this counter's path)."""
        if self._served_wrapped:
            for flags, i in self._served_wrapped:
                self._wrapped_host += int(flags[i])
            self._served_wrapped.clear()
        return self._wrapped_host

    @property
    def overflows(self) -> int:
        """Draw lanes that overflowed ``cap`` across all dispatches."""
        return int(self._overflow_dev)

    def __iter__(self) -> Iterator[Dict[str, object]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch (double buffering) over a step-indexed
    source; safe to restart from any step.

    The thread calls the source, so on the card its launches go to the
    thread's current CUDA stream: the device's default stream unless the
    caller made another current in that thread. Work of the two threads
    on the default stream stays in issue order."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        # Each step is drawn once: a full queue retries the put, not the
        # call, so the source's served-batch counters see every step once.
        s = self.step
        while not self._stop.is_set():
            item = (s, self.source.batch_at(s))
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            s += 1

    def __next__(self):
        s, b = self.q.get()
        return s, b

    def stop(self):
        """Stop the thread and wait for it: no call of the source is left
        running after this returns."""
        self._stop.set()
        self._thread.join()
