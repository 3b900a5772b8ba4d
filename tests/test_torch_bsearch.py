"""The bsearch kernel's tile logic (``bsearch_probe_tiled``, the plain model
of ``csrc/bsearch_probe.cu``) against the JAX reference's
``bsearch_probe`` (Pallas interpret mode, ``(R, 128)`` query tiles), on
the same numpy inputs.

  * Sorted, shuffled and all-equal queries, a prefix with long runs of
    repeated values (dangling roots have weight 0), queries past
    ``pref[-1]``, ``np_len`` 1 and 2, one query and a ragged last tile, at
    tiny tiles (8), spans (1-64) and pivot levels (0-4), so that both the
    staged brackets and the fallback run, and at the kernel's own: exact,
    and equal to ``bsearch_probe_plain``, the oracle. A hypothesis property
    over random prefixes and queries.
  * The module's constants are the sources' ``#define`` lines.
  * The launch on a fake library: the entries' ``argtypes`` are set once
    and the launch shape is asked for once over many calls; one output
    allocation a call; a CUDA error raises.
  * The main path's callers search the int32 index's own root prefix (a
    view, no copy a call).

The kernel itself runs only on a card, where ``chip_smoke.py`` holds it
against ``bsearch_probe_plain`` and its tile counts against the model's.
"""
import functools
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _optional import given, settings, st
from repro.core import build_shred
from repro.kernels.bsearch_probe import bsearch_probe as r_bsearch
from repro_torch.config import KernelPolicy
from repro_torch.core import PagedArena, shred_from_arrays
from repro_torch.core import probe as t_probe
from repro_torch.kernels import bsearch_probe as t_bp
from repro_torch.kernels import build
from repro_torch.kernels import tree_probe as t_tp

from test_torch_paged import setup
from test_torch_shred import ref_arrays

KINDS = ["sorted", "shuffled", "equal", "past-end", "one", "ragged"]
# (tile, span, levels): brackets staged only when one word wide with no
# pivots, tiny slices and pivot tables, a span over the small prefixes,
# and the kernel's own.
SHAPES = {"span-1": (8, 1, 0), "tiny": (8, 4, 2), "small": (8, 16, 3),
          "wide": (8, 64, 4), "kernel": (t_bp.THREADS * t_bp.ITEMS,
                                         t_bp.SPAN, t_bp.LEVELS)}
PREFS = {"np1": 1, "np2": 2, "np3": 3, "runs": 400, "np2000": 2000}


@functools.lru_cache(maxsize=None)
def prefix(name: str) -> np.ndarray:
    """An int32 exclusive prefix with pref[0] == 0: random steps of 0-3
    words, or (``runs``) long runs of one value, as zero-weight roots
    give."""
    length = PREFS[name]
    rng = np.random.default_rng(length)
    if name == "runs":
        steps = rng.integers(1, 9, length - 1) * (rng.random(length - 1) < 0.1)
    else:
        steps = rng.integers(0, 4, length - 1)
    return np.concatenate([[0], np.cumsum(steps)]).astype(np.int32)


def queries(kind: str, pref: np.ndarray) -> np.ndarray:
    rng = np.random.default_rng(len(kind) + len(pref))
    top = int(pref[-1])
    q = {"sorted": lambda: np.sort(rng.integers(0, top + 1, 700)),
         "shuffled": lambda: rng.integers(0, top + 1, 700),
         "equal": lambda: np.full(300, rng.integers(0, top + 1)),
         "past-end": lambda: np.sort(rng.integers(top - 2, top + 50, 200)),
         "one": lambda: rng.integers(0, top + 1, 1),
         "ragged": lambda: np.sort(rng.integers(0, top + 1, 3 * 8 + 5)),
         }[kind]()
    return np.maximum(q, 0).astype(np.int32)


@functools.lru_cache(maxsize=None)
def reference(name: str, kind: str) -> np.ndarray:
    """The JAX kernel's answers, run as its own tests run it: queries in
    (R, 128) tiles (the last row padded), Pallas interpret mode."""
    pref, q = prefix(name), queries(kind, prefix(name))
    tiles = np.pad(q, (0, (-q.size) % 128), mode="edge").reshape(-1, 128)
    out = r_bsearch(jnp.asarray(pref), jnp.asarray(tiles), interpret=True)
    return np.asarray(out).reshape(-1)[:q.size]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(PREFS))
def test_tiled_search_matches_reference(name, kind, shape):
    pref, q = prefix(name), queries(kind, prefix(name))
    tile, span, levels = SHAPES[shape]
    tp, tq = torch.from_numpy(pref), torch.from_numpy(q)
    stats = {}
    got = t_bp.bsearch_probe_tiled(tp, tq, tile=tile, span=span,
                                   levels=levels, stats=stats)
    assert got.dtype == torch.int32 and got.shape == tq.shape
    np.testing.assert_array_equal(got.numpy(), reference(name, kind))
    np.testing.assert_array_equal(got.numpy(),
                                  t_bp.bsearch_probe_plain(tp, tq).numpy())
    assert stats["tiles"] == -(-q.size // tile)
    assert stats["staged"] + stats["fallback"] == stats["tiles"]


@pytest.mark.parametrize("name", ["runs", "np2000"])
def test_tiled_search_takes_both_paths(name):
    """Sorted queries at a tiny span stage some tiles and fall back on
    others; shuffled queries at the kernel's tile fall back on every wide
    prefix."""
    pref = torch.from_numpy(prefix(name))
    q = torch.from_numpy(queries("sorted", prefix(name)))
    stats = {}
    t_bp.bsearch_probe_tiled(pref, q, tile=8, span=16, levels=3, stats=stats)
    assert 0 < stats["staged"] < stats["tiles"], stats
    top = int(pref[-1])
    shuffled = torch.from_numpy(np.random.default_rng(0).integers(
        0, top + 1, 4096).astype(np.int32))
    t_bp.bsearch_probe_tiled(pref, shuffled, tile=1024, span=64, levels=4,
                             stats=stats)
    assert stats["staged"] == 0 and stats["fallback"] == 4, stats


def test_the_wrapper_on_the_cpu_is_the_plain_version():
    pref = torch.from_numpy(prefix("runs"))
    q = torch.from_numpy(queries("shuffled", prefix("runs"))).reshape(7, 100)
    want = t_bp.bsearch_probe_plain(pref, q)
    before = t_bp.bsearch_probe.launches
    assert torch.equal(t_bp.bsearch_probe(pref, q), want)
    stats = {}
    assert torch.equal(t_bp.bsearch_probe(pref, q, stats=stats), want)
    assert stats["tiles"] == 1 and t_bp.bsearch_probe.launches == before
    empty = torch.zeros((0,), dtype=torch.int32)
    assert t_bp.bsearch_probe_tiled(pref, empty).shape == (0,)
    with pytest.raises(TypeError):
        t_bp.bsearch_probe(pref.long(), q)
    with pytest.raises(ValueError):
        t_bp.bsearch_probe_tiled(pref, q, levels=31)


@settings(max_examples=150, deadline=None)
@given(steps=st.lists(st.integers(0, 5), min_size=0, max_size=300),
       queries_=st.lists(st.integers(0, 1600), min_size=1, max_size=90),
       tile=st.sampled_from([1, 3, 8, 32]), span=st.integers(1, 64),
       levels=st.integers(0, 9), sort_queries=st.booleans())
def test_tiled_search_property(steps, queries_, tile, span, levels,
                               sort_queries):
    pref = torch.from_numpy(np.concatenate([[0], np.cumsum(steps)]).astype(
        np.int32))
    q = torch.tensor(sorted(queries_) if sort_queries else queries_,
                     dtype=torch.int32)
    got = t_bp.bsearch_probe_tiled(pref, q, tile=tile, span=span,
                                   levels=levels)
    assert torch.equal(got, t_bp.bsearch_probe_plain(pref, q))


def _defines(name: str) -> dict:
    text = (Path(t_bp.__file__).parent / "csrc" / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"^#define (\w+) (\d+)\s*$", text, re.M)}


def test_constants_match_the_sources():
    get, bp = _defines("tree_get.cuh"), _defines("bsearch_probe.cu")
    assert (t_bp.THREADS, t_bp.SPAN, t_bp.LEVELS) == (
        get["TG_THREADS"], get["TG_SPAN"], get["TG_LEVELS"])
    assert t_bp.ITEMS == bp["BP_ITEMS"]
    # the GET's model searches with the same constants
    assert (t_tp.THREADS, t_tp.SPAN, t_tp.LEVELS) == (
        t_bp.THREADS, t_bp.SPAN, t_bp.LEVELS)
    src = (Path(t_bp.__file__).parent / "csrc" / "bsearch_probe.cu").read_text()
    assert '#include "tree_get.cuh"' in src and "tg_search<" in src


# --- the launch, on a fake library ---------------------------------------------

class _Entry:
    """A C entry that counts its calls and how often its argtypes are set."""

    def __init__(self, log, name, rc):
        object.__setattr__(self, "_log", log)
        object.__setattr__(self, "_name", name)
        object.__setattr__(self, "_rc", rc)

    def __setattr__(self, attr, value):
        self._log.append((self._name, f"set {attr}"))
        object.__setattr__(self, attr, value)

    def __call__(self, *args):
        self._log.append((self._name, "call"))
        if self._name == "bsearch_probe_config":
            args[0][:] = [1024, 8, 132, 12424]
        return self._rc


def _fake_card(monkeypatch, log, rc=0):
    entries = {}

    def library(name):
        assert name == "bsearch_probe"
        return types.SimpleNamespace(**{
            e: entries.setdefault(e, _Entry(log, e, rc if e.endswith(
                "launch") else 0))
            for e in ("bsearch_probe_launch", "bsearch_probe_config")})
    monkeypatch.setattr(build, "library", library)
    monkeypatch.setattr(build, "_ENTRIES", {})
    monkeypatch.setattr(t_bp, "_CONFIGS", {})
    monkeypatch.setattr(build, "current_stream", lambda d: 0)


def test_argtypes_and_launch_shape_are_set_once(monkeypatch):
    log, allocs = [], []
    _fake_card(monkeypatch, log)
    empty_like = torch.empty_like
    monkeypatch.setattr(torch, "empty_like",
                        lambda *a, **k: allocs.append(1) or empty_like(*a, **k))
    pref = torch.from_numpy(prefix("np2000"))
    q = torch.from_numpy(queries("sorted", prefix("np2000")))
    for _ in range(20):
        t_bp._launch(pref, q, None)
    assert log.count(("bsearch_probe_launch", "set argtypes")) == 1
    assert log.count(("bsearch_probe_config", "set argtypes")) == 1
    assert log.count(("bsearch_probe_config", "call")) == 1
    assert log.count(("bsearch_probe_launch", "call")) == 20
    assert len(allocs) == 20


def test_a_launch_error_raises(monkeypatch):
    _fake_card(monkeypatch, [], rc=700)
    pref = torch.from_numpy(prefix("np3"))
    with pytest.raises(RuntimeError, match="bsearch_probe: CUDA error 700"):
        t_bp._launch(pref, torch.zeros(5, dtype=torch.int32), None)


# --- the main path's callers ---------------------------------------------------

@pytest.mark.parametrize("paged", [False, True])
def test_root_prefix_is_a_view_of_the_index(paged):
    _, q, _, rdb, _ = setup("chain")
    port = shred_from_arrays(ref_arrays(build_shred(rdb, q)), device="cpu")
    if paged:
        port.paged, port.packed = PagedArena.from_packed(port.packed), None
    buf = port.paged.buffer if paged else port.packed.arena
    pref32 = port.root_pref32
    assert pref32.dtype == torch.int32
    assert pref32.data_ptr() == buf.data_ptr()  # a view: nothing copied
    assert torch.equal(pref32.long(), port.root_prefE)
    n = int(port.join_size)
    pos = torch.arange(n, dtype=torch.int64)
    j, local = t_probe._root_locate(port, pos, KernelPolicy(prefer=True))
    want = torch.clamp(torch.searchsorted(port.root_prefE, pos, right=True)
                       - 1, 0, port.root.num_rows - 1)
    assert torch.equal(j.long(), want)
    assert torch.equal(local, pos - port.root_prefE[want])
