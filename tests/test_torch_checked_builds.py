"""The checked builds of the scan, the bsearch kernel, the CSR walks and the
per-page GET, wired to their libraries with a fake card, and mirrored
against their sources.

  * every source of ``build.SOURCES`` has a checked build in
    ``build.VARIANTS``, built with a ``*_CHECK_BOUNDS`` flag that its source
    tests; the four that take ``csrc/bounds_check.cuh`` name their entries
    after themselves, and the header keeps ``build.CHECK_RECORDS`` records
    and room for the most ranges a launch sets;
  * ``prefix_sum.out_of_bounds`` (int32, float32, float64) and
    ``geo_gaps.out_of_bounds`` set the input, the output, the ticket's word
    and exactly the status words ``_words_needed`` reserves as the byte
    ranges, set the look-back's tile to the production build's choice,
    launch the checked entry (never the production one) on the current
    stream's scratch, report when that launch grew it, and count no
    launch; ``bsearch_probe.out_of_bounds``, ``csr_walk.out_of_bounds`` and
    ``tree_probe.paged_out_of_bounds`` set every operand (the per-page
    form each launch's own page) and launch with the production grid;
    each names a faked record by its nearest operand, and each refuses the
    CPU;
  * ``prefix_sum._words_needed`` covers the highest status word the kernel
    addresses (``csrc/scan.cu``'s formulas, written out below) for every
    entry and tile at one element, around each tile, around a chunk of
    tile totals and at Cast's rows, and every group sum a float tile waits
    on is one that a tile of the launch publishes.

The card, the launches and the records are faked; ``chip_smoke.py`` runs
the builds themselves on the card, at the main path's shapes and ragged
ones (phases A, C, D, E and F).
"""
import contextlib
import re
import types

import pytest
import torch

from repro_torch.core import Atom, Database, JoinQuery, PagedArena
from repro_torch.engine import QueryEngine
from repro_torch.kernels import bsearch_probe, build, csr_walk, geo_gaps
from repro_torch.kernels import prefix_sum as ps
from repro_torch.kernels import tree_probe

NEW = {"scan_checked": ("scan", "-DSC_CHECK_BOUNDS"),
       "bsearch_probe_checked": ("bsearch_probe", "-DBP_CHECK_BOUNDS"),
       "csr_walk_checked": ("csr_walk", "-DCW_CHECK_BOUNDS"),
       "tree_probe_paged_checked": ("tree_probe_paged", "-DTPP_CHECK_BOUNDS")}


class _FakeCard:
    """A CPU tensor that claims a CUDA device (the wrappers' checks)."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape, self.ndim = t.dtype, t.shape, t.ndim

    def contiguous(self):
        return self

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.t.data_ptr()

    def numel(self):
        return self.t.numel()

    def element_size(self):
        return self.t.element_size()

    def reshape(self, *shape):
        return _FakeCard(self.t.reshape(*shape))

    def __getitem__(self, i):
        return _FakeCard(self.t[i])


class _Card:
    """The fake card's library: ``entries`` (lib, name) -> a callable, the
    ranges the last ``check_set`` set, the launches made and a record to
    fake, an offset past the end of a named range."""

    def __init__(self):
        self.spans, self.all_spans, self.calls = [], [], []
        self.record = None  # (range index, bytes past its end)
        self.entries = {}

    def check_set(self, lo, hi, n):
        self.spans = [(lo[i], hi[i]) for i in range(n)]
        self.all_spans.append(self.spans)
        return 0

    def check_get(self, count, rec):
        count._obj.value = 0
        if self.record is not None:
            k, past = self.record
            count._obj.value = 1
            rec[0], rec[1], rec[2] = self.spans[k][1] + past, 4, 321
        return 0

    def launch(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn

    def checked(self, lib, source, launches):
        self.entries[(lib, f"{source}_check_set")] = self.check_set
        self.entries[(lib, f"{source}_check_get")] = self.check_get
        for name in launches:
            self.entries[(lib, name)] = self.launch(name)


@pytest.fixture
def card(monkeypatch):
    c = _Card()
    monkeypatch.setattr(build, "entry", lambda lib, name, argtypes:
                        c.entries[(lib, name)])
    for fn in ("empty", "zeros"):
        real = getattr(torch, fn)
        monkeypatch.setattr(torch, fn, (lambda real: lambda *a, **kw: real(
            *a, **{**kw, "device": "cpu"}))(real))
    real_like = torch.empty_like
    monkeypatch.setattr(torch, "empty_like", lambda t, **kw: _FakeCard(
        real_like(t.t if isinstance(t, _FakeCard) else t, **kw)))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=0,
                                              synchronize=lambda: None))
    monkeypatch.setattr(build, "on_device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(build, "current_stream", lambda d: 7)
    monkeypatch.setattr(ps, "_SCRATCH", {})
    return c


def _bytes(t) -> int:
    return t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# The builds against their sources
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", build.SOURCES)
def test_every_source_has_a_checked_build(source):
    checked = [(name, flags) for name, (src, flags) in build.VARIANTS.items()
               if src == source]
    assert len(checked) == 1, checked
    name, flags = checked[0]
    assert name == f"{source}_checked"
    flag, = flags
    m = re.fullmatch(r"-D(\w+_CHECK_BOUNDS)", flag)
    assert m, flag
    text = (build.CSRC / f"{source}.cu").read_text()
    assert f"#ifdef {m.group(1)}" in text
    if name in NEW:
        assert NEW[name] == (source, flag)
        assert '#include "bounds_check.cuh"' in text
        assert f"BC_CHECK_ENTRIES({source})" in text
        # the header comes before any device code of the source
        assert text.index('#include "bounds_check.cuh"') < text.index(
            "__global__")


def test_the_header_mirrors_the_wrappers():
    text = (build.CSRC / "bounds_check.cuh").read_text()
    records = re.search(r"#define BC_CHECK_RECORDS (\d+)", text)
    ranges = re.search(r"#define BC_CHECK_RANGES (\d+)", text)
    assert records and int(records.group(1)) == build.CHECK_RECORDS
    assert ranges and int(ranges.group(1)) >= 7  # csr_walk's launch sets 7
    for what in ("_check_set(", "_check_get(", "#define __ldg(p)",
                 "#define BC_LD(p)", "#define BC_ST(p, v)",
                 "#define BC_OK(p, bytes)"):
        assert what in text, what


def test_the_checked_walk_ends_at_a_link_outside_its_operands():
    """A next link outside the operands reads as -1 in csr_walk.cu's
    checked build (read as 0 it sent the walk back to row 0, which a
    chain of weight-0 rows never leaves: a launch that never ends), and
    as the plain load in the production build."""
    text = (build.CSRC / "csr_walk.cu").read_text()
    assert "__ldg(nxt" not in text
    assert text.count("row = BC_LDG_OR(nxt + row, -1);") == 2
    header = (build.CSRC / "bounds_check.cuh").read_text()
    checked, plain = header.split("#else")
    assert "#define BC_LDG_OR(p, v) bc_ldg_or((p), (v), __LINE__)" in checked
    assert "#define BC_LDG_OR(p, v) __ldg(p)" in plain


def test_the_scan_routes_every_global_access_through_the_check():
    """scan.cu's global loads, stores, status words and ticket go through
    BC_LD, BC_ST and BC_OK: no raw dereference of the input or the output
    is left."""
    text = (build.CSRC / "scan.cu").read_text()
    body = text[text.index("// ---- int32 and GEO"):]
    assert not re.search(r"\bout\[", body)
    assert not re.search(r"\*reinterpret_cast", text)
    assert text.count("BC_OK(word, 8)") == 4  # two stores, two reads
    assert text.count("BC_OK(ticket, 4)") == 2


# ---------------------------------------------------------------------------
# The wrappers against a fake card
# ---------------------------------------------------------------------------

def _scan_card(card, entry):
    card.checked("scan_checked", "scan",
                 [f"{entry}_launch", "scan_check_tile"])
    card.entries[("scan", "scan_look_back_tile")] = (
        lambda n, tile: setattr(tile._obj, "value", ps.LOOK_BACK_SMALL_TILE)
        or 0)


@pytest.mark.parametrize("dtype,entry", [(torch.int32, "scan_i32"),
                                         (torch.float32, "scan_f32"),
                                         (torch.float64, "scan_f64")])
def test_scan_out_of_bounds_runs_the_checked_build(card, dtype, entry):
    _scan_card(card, entry)
    before = (ps.prefix_sum_tiles.launches, ps.prefix_sum_tiles.float32.launches,
              ps.prefix_sum_tiles.float64.launches)
    results, capacity, grew = [], 0, []
    for n in (1, ps.TILE + 1, ps.TILE - 1, 40_000):
        x = _FakeCard(torch.zeros(n, dtype=dtype))
        card.record = (3, 8)  # past the status words
        out = ps.out_of_bounds(x)
        results.append(out)
        need = ps._words_needed(entry, n)
        grows = need > capacity  # _look_back_scratch's rule
        if grows:
            capacity = 1 << (need - 1).bit_length()
        grew.append(grows)
        assert out["words"] == need and out["grown"] == grows, (n, out)
        lo_hi = card.spans
        assert [hi - lo for lo, hi in lo_hi] == [
            n * x.element_size(), n * x.element_size(), 8, 8 * (need - 1)]
        s = ps._SCRATCH[(0, 7)]
        assert lo_hi[2][0] == s.words.data_ptr()
        assert lo_hi[3][0] == s.words.data_ptr() + 8
        name, args = card.calls[-1]
        assert name == f"{entry}_launch"
        assert args[0] == x.data_ptr() and args[2] == n
        assert args[3] == s.words.data_ptr() and args[4] == s.capacity
        assert out["count"] == 1
        (line, operand, offset, size, nbytes), = out["loads"]
        assert (line, operand, offset - size, nbytes) == (321, "status", 8, 4)
    assert grew[0] and grew[-1] and not grew[2]
    tiles = [c for c in card.calls if c[0] == "scan_check_tile"]
    if entry == "scan_i32":
        assert tiles and all(a == (ps.LOOK_BACK_SMALL_TILE,) for _, a in tiles)
        assert results[0]["tile"] == ps.LOOK_BACK_SMALL_TILE
    else:
        assert not tiles and results[0]["tile"] is None
    assert (ps.prefix_sum_tiles.launches, ps.prefix_sum_tiles.float32.launches,
            ps.prefix_sum_tiles.float64.launches) == before


def test_scan_out_of_bounds_keeps_a_view_and_its_output(card):
    """An input that starts one element into its allocation keeps its
    offset (the kernel's scalar path), and a given output is the one
    launched into and held."""
    _scan_card(card, "scan_i32")
    buf, obuf = torch.zeros(101, dtype=torch.int32), torch.zeros(
        101, dtype=torch.int32)
    x, o = _FakeCard(buf[1:]), _FakeCard(obuf[1:])
    out = ps.out_of_bounds(x, o)
    assert out["out"] is o and out["count"] == 0
    name, args = card.calls[-1]
    assert args[0] == buf.data_ptr() + 4 and args[1] == obuf.data_ptr() + 4
    assert card.spans[0] == (buf.data_ptr() + 4, buf.data_ptr() + 404)


def test_geo_out_of_bounds_runs_the_checked_build(card):
    _scan_card(card, "geo_gaps")
    u = _FakeCard(torch.full((5000,), 0.5))
    before = geo_gaps.geo_gaps_tiles.launches
    card.record = (0, 0)  # the first byte past the uniforms
    out = geo_gaps.out_of_bounds(u, 2.0)
    name, args = card.calls[-1]
    assert name == "geo_gaps_launch"
    assert args[1] == pytest.approx(geo_gaps.clip_p(2.0)) and args[3] == 5000
    assert out["out"].dtype == torch.int32
    need = ps._words_needed("geo_gaps", 5000)
    assert [hi - lo for lo, hi in card.spans] == [20000, 20000, 8,
                                                  8 * (need - 1)]
    (line, operand, offset, size, nbytes), = out["loads"]
    assert (operand, offset, size) == ("x", 20000, 20000)
    assert geo_gaps.geo_gaps_tiles.launches == before


@pytest.mark.parametrize("block_rows,stats", [(None, False), (2, True),
                                              (16, False)])
def test_bsearch_out_of_bounds_runs_the_checked_build(card, block_rows,
                                                      stats):
    card.checked("bsearch_probe_checked", "bsearch_probe",
                 ["bsearch_probe_launch"])
    items = bsearch_probe.items_for(block_rows)

    def config(cfg, it):
        cfg[0], cfg[1], cfg[2], cfg[3] = 256 * it, 3, 132, 0
        return 0

    card.entries[("bsearch_probe", "bsearch_probe_config")] = config
    monkey_cfg = bsearch_probe._CONFIGS
    monkey_cfg.clear()
    pref = _FakeCard(torch.arange(0, 3000, 3, dtype=torch.int32))
    q = _FakeCard(torch.arange(5000, dtype=torch.int32))
    card.record = (0, 4)
    before = bsearch_probe.bsearch_probe.launches
    out = bsearch_probe.out_of_bounds(pref, q, block_rows, stats)
    monkey_cfg.clear()
    name, args = card.calls[-1]
    assert name == "bsearch_probe_launch"
    tile = 256 * items
    assert args[1:3] == (1000, bsearch_probe.steps_for(1000))
    assert args[5:7] == (5000, min(3 * 132, -(-5000 // tile)))
    assert args[-1] == items and (args[7] is not None) == stats
    assert [hi - lo for lo, hi in card.spans] == (
        [4000, 20000, 20000] + ([8] if stats else []))
    (line, operand, offset, size, nbytes), = out["loads"]
    assert (line, operand, offset - size) == (321, "pref", 4)
    assert bsearch_probe.bsearch_probe.launches == before


@pytest.mark.parametrize("cached", [False, True])
def test_csr_out_of_bounds_runs_the_checked_build(card, cached):
    card.checked("csr_walk_checked", "csr_walk", ["csr_walk_launch"])
    weight = _FakeCard(torch.ones(50, dtype=torch.int64))
    nxt = _FakeCard(torch.full((50,), -1, dtype=torch.int32))
    hd = _FakeCard(torch.arange(30, dtype=torch.int32))
    idx = _FakeCard(torch.zeros(30, dtype=torch.int64))
    card.record = (1, 4)  # one row past the chain
    before = (csr_walk.csr_walk.launches, csr_walk.csr_walk_cached.launches)
    out = csr_walk.out_of_bounds(weight, nxt, hd, idx, cached, stats=cached)
    name, args = card.calls[-1]
    assert name == "csr_walk_launch"
    assert args[:4] == tuple(t.data_ptr() for t in (weight, nxt, hd, idx))
    assert args[6:8] == (30, int(cached)) and (args[8] is not None) == cached
    assert [hi - lo for lo, hi in card.spans] == (
        [400, 200, 120, 240, 120, 240] + ([24] if cached else []))
    (line, operand, offset, size, nbytes), = out["loads"]
    assert (operand, offset - size) == ("nxt", 4)
    assert len(out["out"]) == 2
    assert (csr_walk.csr_walk.launches,
            csr_walk.csr_walk_cached.launches) == before


@pytest.fixture
def paged():
    return _paged()


def _paged():
    db = Database.from_columns({
        "Title": {"t": [0, 1, 2, 3], "p": [0.9, 0.5, 0.1, 0.7]},
        "Cast": {"t": [0, 0, 1, 1, 1, 2, 3], "a": [10, 11, 12, 13, 14, 15, 16]},
        "Comp": {"t": [0, 1, 1, 2, 3, 3], "c": [100, 101, 102, 103, 104, 105]},
    }, device="cpu")
    q = JoinQuery((Atom.of("Title", "t", "p"), Atom.of("Cast", "t", "a"),
                   Atom.of("Comp", "t", "c")), prob_var="p")
    plan = QueryEngine(db, device="cpu").compile(q)
    return PagedArena.from_packed(plan.shred.packed), plan.join_size


def test_paged_out_of_bounds_runs_the_checked_build(paged, card):
    """One launch a page, each holding its own page (not the buffer), its
    probes or its parent's row and local, and its output; the count is
    summed and a record past page 1 is named by it."""
    card.checked("tree_probe_paged_checked", "tree_probe_paged",
                 ["tpp_root_launch", "tpp_edge_launch"])
    pv, n = paged
    fake = types.SimpleNamespace(
        layout=pv.layout, buffer=_FakeCard(pv.buffer),
        pages=[_FakeCard(p) for p in pv.pages])
    q = _FakeCard(torch.arange(n, dtype=torch.int32))
    card.record = (0, 4)  # past each launch's page
    before = (tree_probe.tree_probe_paged.launches,
              tree_probe.tree_probe_paged_pages.launches)
    out = tree_probe.paged_out_of_bounds(fake, q)
    edges = len(pv.layout.edges)
    assert out["launches"] == 1 + edges == len(card.all_spans)
    assert [c[0] for c in card.calls] == ["tpp_root_launch"] + [
        "tpp_edge_launch"] * edges
    for k, spans in enumerate(card.all_spans):
        page = pv.pages[k]
        assert spans[0] == (page.data_ptr(), page.data_ptr() + _bytes(page))
        assert [hi - lo for lo, hi in spans[1:]] == (
            [4 * n, 8 * n] if k == 0 else [4 * n, 4 * n, 12 * n])
    assert out["count"] == 1 + edges
    assert [r[1] for r in out["loads"]] == [f"page {k}"
                                            for k in range(1 + edges)]
    assert out["out"].shape == (pv.layout.num_slots, n)
    assert (tree_probe.tree_probe_paged.launches,
            tree_probe.tree_probe_paged_pages.launches) == before


def test_get_out_of_bounds_returns_its_rows(paged, card):
    """The GET's checked build (``tree_get_checked``) sets the
    arena, the probes and the rows as the ranges, launches at its own
    configuration's grid, and returns the rows it wrote beside the
    count."""
    card.checked("tree_get_checked", "tree_get", ["tree_get_launch"])

    def config(table, cfg, items):
        cfg[0], cfg[1], cfg[2], cfg[3] = items, 5, 132, 0
        return 0

    card.entries[("tree_get_checked", "tree_get_config")] = config
    pv, n = paged
    arena, q = _FakeCard(pv.buffer), _FakeCard(torch.arange(
        n, dtype=torch.int32))
    before = tree_probe.tree_probe.launches
    out = tree_probe.out_of_bounds(arena, q, pv.layout)
    name, args = card.calls[-1]
    items = tree_probe.items_for(pv.layout.num_slots)
    assert name == "tree_get_launch" and args[4:] == (n, 1, 0, items)
    assert [hi - lo for lo, hi in card.spans] == [
        _bytes(pv.buffer), 4 * n, 4 * n * pv.layout.num_slots]
    assert out["count"] == 0 and out["out"].shape == (pv.layout.num_slots, n)
    assert tree_probe.tree_probe.launches == before


def test_checked_wrappers_refuse_the_cpu():
    x = torch.zeros(10, dtype=torch.int32)
    with pytest.raises(ValueError, match="on the card"):
        ps.out_of_bounds(x)
    with pytest.raises(ValueError, match="on the card"):
        geo_gaps.out_of_bounds(x.float(), 0.5)
    with pytest.raises(ValueError, match="on the card"):
        bsearch_probe.out_of_bounds(torch.arange(5, dtype=torch.int32), x)
    w = torch.ones(5, dtype=torch.int64)
    with pytest.raises(ValueError, match="on the card"):
        csr_walk.out_of_bounds(w, w.int(), x, x.long())
    pv, n = _paged()
    with pytest.raises(ValueError, match="on the card"):
        tree_probe.paged_out_of_bounds(pv, torch.arange(n, dtype=torch.int32))
    with pytest.raises(ValueError, match="on the card"):
        build.bounds_check("scan_checked", None, (), "cpu")


# ---------------------------------------------------------------------------
# The scratch the scans reserve against the words they address
# ---------------------------------------------------------------------------

def _look_back_words(n: int, tile: int) -> int:
    """csrc/scan.cu sc_look_back_kernel: tile t publishes status[t] (word
    1 + t; word 0 holds the ticket) and looks back over status[j], j < t."""
    ntiles = -(-n // tile)
    return 1 + (ntiles - 1) + 1


def _fixed_words(n: int, W: int) -> int:
    """csrc/scan.cu sc_fixed_kernel, sc_publish_group and sc_carry_at: the
    words (W a float, status from word 1) that the launch over n elements
    addresses, the ticket's included; asserts every group sum a tile waits
    on is published by a tile of the launch."""
    T, I, TH = ps.TILE, ps.ITEMS, ps.THREADS
    ntiles = -(-n // T)
    groups = 1 + W * ntiles  # sc_fixed_kernel: status + ntiles * W
    published = ntiles // I  # groups whose last tile exists
    top = 0

    def group(g):
        assert 0 <= g < published, (n, g, published)
        return groups + W * g + W - 1

    for t in range(ntiles):
        top = max(top, 1 + W * t + W - 1)  # its total
        if t % I == I - 1:
            top = max(top, group(t // I))  # its group's sum
        if t == 0:
            continue
        last = t - 1
        c, cbase = last // T, last // T * T
        q = (last - cbase) // I
        if c > 0:
            top = max(top, group((c - 1) * TH + TH - 1))
        if q > 0:
            top = max(top, group(c * TH + q - 1))
        top = max(top, 1 + W * last + W - 1)  # the totals before it
    return top + 1


_FLOAT_SIZES = (1, ps.TILE - 1, ps.TILE, ps.TILE + 1, 16 * ps.TILE - 1,
                16 * ps.TILE + 1, ps.TILE * ps.TILE - 1, ps.TILE * ps.TILE,
                ps.TILE * ps.TILE + 1, ps.TILE * (ps.TILE + 16) + 1,
                36_244_344)
_LOOK_BACK_SIZES = (1, ps.LOOK_BACK_SMALL_TILE - 1, ps.LOOK_BACK_SMALL_TILE + 1,
                    ps.LOOK_BACK_TILE - 1, ps.LOOK_BACK_TILE + 1,
                    33 * ps.LOOK_BACK_TILE + 7, 36_244_344)


@pytest.mark.parametrize("entry,W", [("scan_f32", 1), ("scan_f64", 2)])
@pytest.mark.parametrize("n", _FLOAT_SIZES)
def test_words_needed_covers_the_float_scans(entry, W, n):
    assert _fixed_words(n, W) <= ps._words_needed(entry, n)


@pytest.mark.parametrize("entry", ["scan_i32", "geo_gaps"])
@pytest.mark.parametrize("n", _LOOK_BACK_SIZES)
def test_words_needed_covers_the_look_back(entry, n):
    for tile in (ps.LOOK_BACK_TILE, ps.LOOK_BACK_SMALL_TILE):
        assert _look_back_words(n, tile) <= ps._words_needed(entry, n)


def test_the_word_formulas_read_the_source():
    """The formulas above are the source's: its tile sizes, and the float
    launch's groups after ntiles words a float of totals."""
    text = (build.CSRC / "scan.cu").read_text()
    defs = dict(re.findall(r"#define (SC_THREADS|SC_ITEMS|LB_THREADS|LB_ITEMS|"
                           r"LB_SMALL_ITEMS) (\d+)", text))
    assert int(defs["SC_THREADS"]) == ps.THREADS
    assert int(defs["SC_ITEMS"]) == ps.ITEMS
    assert int(defs["LB_THREADS"]) * int(defs["LB_ITEMS"]) == ps.LOOK_BACK_TILE
    assert (int(defs["LB_THREADS"]) * int(defs["LB_SMALL_ITEMS"])
            == ps.LOOK_BACK_SMALL_TILE)
    assert ("groups = status + ntiles * (long long)(sizeof(T) / 4)" in text)
    assert "lb_publish(status + tile, LB_PREFIX" in text
