"""The executors behind the engine's Poisson entry points.

One executor is a plain callable with ``(method, project)`` bound; the
plan keeps it for its lifetime. PyTorch runs eagerly, so there is no trace
to cache: a warm draw is the executor call itself.

The batched executor serves B keys in one dispatch, with a leading batch
axis on every output. On the fused and paged routes that is one launch of
the draw kernel for all B keys (and, paged, one GET launch over the B x
cap lanes); on the per-node route each key draws its positions with its
own generators, then one GET and one set of column gathers serve all
lanes. Every step is per key or per lane, so lane b equals the single
draw under ``keys[b]``. Callers pad the keys to a power-of-two bucket
(``pad_batch_keys``), as the reference does to reuse its traces: here it
keeps the launch shapes of warm batches few.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.config import DEFAULT_POLICY, KernelPolicy
from repro_torch.core import probe, sampling
from repro_torch.core.poisson import JoinSample
from repro_torch.core.shred import Shred
from repro_torch.kernels import threefry

__all__ = ["sample_executor", "batched_sample_executor", "empty_sample",
           "empty_sample_batch", "uniform_positions_fn", "bucket_size",
           "pad_batch_keys"]


def _positions(key, w, p, prefE, shred: Shred, cap: int, method: str,
               n: int, acap: int, narrow: bool,
               policy: KernelPolicy) -> sampling.PositionSample:
    """The per-node route's positions under one key."""
    if method == "exprace":
        return sampling.exprace_positions(
            key, w, p, prefE, cap, arrival_cap=acap,
            pref32=shred.root_pref32 if narrow else None, policy=policy)
    if method == "ptbern_flat":  # n is the join size
        return sampling.pt_bern_flat_positions(key, p, prefE, n, cap)
    raise ValueError(f"unknown sampling method {method!r}")


def _sample(shred: Shred, w, p, prefE, key, cap: int, rep: str, method: str,
            n: int = 0, acap: int = 0, project=None, narrow: bool = False,
            route: str = "pernode", dparams=None,
            policy: KernelPolicy = DEFAULT_POLICY) -> JoinSample:
    if route in ("fused", "reference"):
        # One-launch draw: positions AND per-node rows come out of one
        # kernel (or its plain version); only the column gather remains.
        node_rows, ps = probe.draw_fused(
            shred, dparams, key, method=method, cap=cap, acap=acap, n=n,
            reference=(route == "reference"))
        cols = probe.gather_columns(shred, node_rows)
    elif route == "paged":
        # The sampling launch, then the walk page by page.
        node_rows, ps = probe.draw_paged(shred, dparams, key, method=method,
                                         cap=cap, acap=acap, n=n)
        cols = probe.gather_columns(shred, node_rows)
    else:
        ps = _positions(key, w, p, prefE, shred, cap, method, n, acap, narrow,
                        policy)
        pos = torch.minimum(ps.positions, torch.clamp(prefE[-1] - 1, min=0))
        cols = probe.get(shred, pos, rep=rep, policy=policy)
    if project is not None:
        cols = {v: c for v, c in cols.items() if v in project}
    return JoinSample(cols, ps.positions, ps.count, ps.overflow)


def sample_executor(method: str, project: Optional[tuple]):
    """The Poisson-sample executor with (method, project) bound."""
    return partial(_sample, method=method, project=project)


def _sample_batch(shred: Shred, w, p, prefE, keys, cap: int, rep: str,
                  method: str, n: int = 0, acap: int = 0, project=None,
                  narrow: bool = False, route: str = "pernode",
                  dparams=None,
                  policy: KernelPolicy = DEFAULT_POLICY) -> JoinSample:
    if route in ("fused", "reference"):
        node_rows, ps = probe.draw_fused_batch(
            shred, dparams, keys, method=method, cap=cap, acap=acap, n=n,
            reference=(route == "reference"))
        cols = probe.gather_columns(shred, node_rows)
    elif route == "paged":
        node_rows, ps = probe.draw_paged_batch(shred, dparams, keys,
                                               method=method, cap=cap,
                                               acap=acap, n=n)
        cols = probe.gather_columns(shred, node_rows)
    else:
        # Positions key by key, each from its own generators; then one GET
        # over every lane of the batch.
        per_key = [_positions(k, w, p, prefE, shred, cap, method, n, acap,
                              narrow, policy)
                   for k in threefry.key_batch(keys)]
        ps = sampling.PositionSample(
            torch.stack([s.positions for s in per_key]),
            torch.stack([s.count for s in per_key]),
            torch.stack([s.overflow for s in per_key]))
        pos = torch.minimum(ps.positions, torch.clamp(prefE[-1] - 1, min=0))
        cols = {v: c.reshape(pos.shape) for v, c in probe.get(
            shred, pos.reshape(-1), rep=rep, policy=policy).items()}
    if project is not None:
        cols = {v: c for v, c in cols.items() if v in project}
    return JoinSample(cols, ps.positions, ps.count, ps.overflow)


def batched_sample_executor(method: str, project: Optional[tuple]):
    """The multi-draw executor with (method, project) bound: one dispatch
    serves B independent draws into (B, cap) buffers with per-draw counts
    and overflow flags; its arguments are ``sample_executor``'s with
    ``keys`` (B, 2) for ``key``."""
    return partial(_sample_batch, method=method, project=project)


def bucket_size(b: int) -> int:
    """The power-of-two batch bucket ``b`` lands in."""
    if b < 1:
        raise ValueError(f"batch size must be >= 1, got {b}")
    return 1 if b <= 1 else 1 << (b - 1).bit_length()


def pad_batch_keys(keys) -> Tuple[np.ndarray, int]:
    """Pad a batch of keys to its power-of-two bucket by repeating the last
    key; returns ``(padded (bucket, 2) uint32 words, B)``. Padding lanes
    are sliced off by the caller after the dispatch."""
    words = threefry.key_batch(keys)
    b = words.shape[0]
    bp = bucket_size(b)
    if bp == b:
        return words, b
    return words[np.minimum(np.arange(bp), b - 1)], b


def empty_sample(shred: Shred, cap: int) -> JoinSample:
    """An all-padding sample (used when |Q(db)| == 0: nothing to probe)."""
    dev = shred.device
    cols = {v: torch.zeros((cap,), dtype=node.data.column(v).dtype, device=dev)
            for node in shred.root.nodes() for v in node.owned}
    return JoinSample(cols, torch.zeros((cap,), dtype=torch.int64, device=dev),
                      torch.zeros((), dtype=torch.int64, device=dev),
                      torch.zeros((), dtype=torch.bool, device=dev))


def empty_sample_batch(shred: Shred, cap: int, batch: int) -> JoinSample:
    """The batched all-padding sample: ``empty_sample`` broadcast to B
    lanes."""
    one = empty_sample(shred, cap)
    grow = lambda x: x.expand((batch,) + x.shape)  # noqa: E731
    return JoinSample({v: grow(c) for v, c in one.columns.items()},
                      grow(one.positions), grow(one.count),
                      grow(one.overflow))


def uniform_positions_fn(method: str):
    """Position sampler for uniform beta_p (paper §6.1
    BERN/GEO/BINOM/HYBRID)."""
    return {
        "bern": sampling.bern_positions,
        "geo": sampling.geo_positions,
        "binom": sampling.binom_positions,
        "hybrid": sampling.hybrid_positions,
    }[method]
