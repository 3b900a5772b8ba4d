"""The two scan designs of the port's CUDA kernels, checked on the CPU.

  * The int32 prefix sum's single-pass decoupled look-back
    (``csrc/scan.cu``): a Python model of its protocol (an atomic ticket
    per tile taken relative to the host's ticket base, 64-bit status words
    holding a flag, the launch's epoch and an aggregate or an inclusive
    prefix, one warp looking back 32 predecessors at a time) run under many
    random interleavings and residencies. Every run must equal
    ``wrap_i32(cumsum)`` exactly, across ragged sizes, more than 32 tiles
    (the look-back crosses several windows) and uint32 wrap; and so must
    many launches of both tile sizes in turn on one reused scratch, with
    no reset between them, through epoch wraps and a ticket that wraps.
  * The wrapper's scratch on a fake library: one per (device, stream),
    made once and grown, never allocated in steady state; a refused
    launch drops it.
  * The one float32 order function (``prefix_sum.scan_order``) at tiny
    tile constants, for both of its users: the float32 prefix sum and the
    fused draw's arrivals. Each is held bit for bit against a scalar numpy
    emulation of ``csrc/scan.cuh``'s tile function and chunked carries.
  * The Python tile constants are the CUDA sources' own.
  * The floats' one-launch protocol: the tiles publish their totals, the
    group sums follow, then each tile computes its carry from them in
    ``sc_carries``' order (``csrc/scan.cu`` ``sc_carry_at``), modelled in
    torch at tiny tiles over one and many chunks of totals; it equals
    ``scan_order`` bit for bit in float32 and float64. The float entries
    take the look-back's cached scratch, never one of their own a call.

On the card ``chip_smoke.py`` holds the kernels themselves against these
plain versions.
"""
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import fused_draw as t_fd
from repro_torch.kernels import geo_gaps as t_geo
from repro_torch.kernels import prefix_sum as t_ps
from repro_torch.kernels import threefry as t_threefry

CSRC = Path(t_ps.__file__).resolve().parent / "csrc"
MASK = (1 << 32) - 1
AGGREGATE, PREFIX = 1, 2
EPOCH_BITS = 30
EPOCH_MAX = (1 << EPOCH_BITS) - 1
WINDOW = 32  # lanes of the looking-back warp


class Scratch:
    """The look-back's scratch and the host's state for it, as
    ``csrc/scan.cu``'s ``lb_launch`` keeps them: the status words, the
    ticket counter (never reset), the epoch of the last launch and the
    ticket base; zero when made."""

    def __init__(self, words: int, epoch_max: int = EPOCH_MAX):
        self.status = [0] * words
        self.ticket = 0
        self.epoch = 0
        self.base = 0
        self.epoch_max = epoch_max
        self.resets = 0


def word(flag: int, epoch: int, value: int) -> int:
    """A status word: flag (2 bits), epoch (30), uint32 value."""
    return (((flag << EPOCH_BITS) | epoch) << 32) | value


def flag_of(w: int, epoch: int) -> int:
    """``lb_flag``: the flag of a word of this epoch, else 0."""
    hi = w >> 32
    return hi >> EPOCH_BITS if hi & EPOCH_MAX == epoch else 0


# --- the look-back protocol -----------------------------------------------------

def look_back_scan(x: np.ndarray, tile: int, rng, resident: int,
                   windows=None, scratch=None) -> np.ndarray:
    """``csrc/scan.cu``'s int32 scan as a protocol among tile blocks,
    interleaved at random, on ``scratch`` (a fresh one if None). The host
    takes the next epoch (clearing the scratch when it would pass
    ``epoch_max``). At most ``resident`` blocks run at once (a block leaves
    when it has written its tile); a block draws its tile from the ticket,
    less the base, when it first runs. Every shared read or write is its
    own step, and the looking-back warp reads its 32 words one lane at a
    time in random order, each lane spinning until its word carries this
    epoch. The number of windows each block read is appended to
    ``windows``."""
    n = x.shape[0]
    nt = -(-n // tile)
    if scratch is None:
        scratch = Scratch(nt)
    assert nt <= len(scratch.status), "the wrapper sizes the scratch"
    epoch = scratch.epoch + 1
    if epoch > scratch.epoch_max:
        scratch.status = [0] * len(scratch.status)
        scratch.ticket = scratch.base = 0
        scratch.resets += 1
        epoch = 1
    base = scratch.base
    status = scratch.status
    xu = x.astype(np.int64) & MASK
    out = np.zeros(n, np.int64)

    def block():
        t = (scratch.ticket - base) & MASK
        scratch.ticket = (scratch.ticket + 1) & MASK
        yield
        local = np.cumsum(xu[t * tile:(t + 1) * tile]) & MASK
        agg = int(local[-1])
        excl = 0
        if t > 0:
            status[t] = word(AGGREGATE, epoch, agg)
            yield
            top, read = t - 1, 0
            while True:
                read += 1
                words, pending = {}, list(range(WINDOW))
                while pending:
                    lane = pending[rng.integers(len(pending))]
                    j = top - lane
                    w = word(PREFIX, epoch, 0) if j < 0 else status[j]
                    if flag_of(w, epoch):
                        words[lane] = w
                        pending.remove(lane)
                    yield
                prefixes = [l for l in range(WINDOW)
                            if flag_of(words[l], epoch) == PREFIX]
                stop = prefixes[0] if prefixes else WINDOW - 1
                excl = (excl + sum(words[l] & MASK
                                   for l in range(stop + 1))) & MASK
                if prefixes:
                    break
                top -= WINDOW
            if windows is not None:
                windows.append(read)
        status[t] = word(PREFIX, epoch, (excl + agg) & MASK)
        yield
        out[t * tile:(t + 1) * tile] = (local + excl) & MASK

    waiting, running, steps = nt, [], 0
    while waiting or running:
        while waiting and len(running) < resident:
            running.append(block())
            waiting -= 1
        g = running[rng.integers(len(running))]
        try:
            next(g)
        except StopIteration:
            running.remove(g)
        steps += 1
        assert steps < 200 * nt * WINDOW, "the look-back made no progress"
    assert all(flag_of(w, epoch) == PREFIX for w in status[:nt])
    scratch.epoch = epoch
    scratch.base = (base + nt) & MASK
    assert scratch.ticket == scratch.base
    return ((out + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)


@pytest.mark.parametrize("n,tile", [(1, 8), (7, 8), (8, 8), (9, 8),
                                    (37 * 8 + 5, 8), (70 * 4, 4),
                                    (33 * 4 + 3, 4)])
def test_look_back_protocol_equals_cumsum(n, tile):
    rng = np.random.default_rng(n * 31 + tile)
    x = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    want = t_ps.wrap_i32(torch.cumsum(torch.from_numpy(x).long(), 0)).numpy()
    for trial in range(12):
        resident = int(rng.choice([1, 2, 3, 8, 64]))
        got = look_back_scan(x, tile, rng, resident)
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")


def test_look_back_crosses_windows_and_wraps():
    """Over 32 tiles whose predecessors are all still aggregates: the warp
    must add whole windows before it meets a prefix, and the sum wraps."""
    rng = np.random.default_rng(5)
    n, tile = 100 * 2, 2
    x = rng.integers(2**29, 2**30, n, dtype=np.int64).astype(np.int32)
    want = t_ps.wrap_i32(torch.cumsum(torch.from_numpy(x).long(), 0)).numpy()
    assert (want < 0).any()  # the running sum wrapped
    windows = []
    for trial in range(20):
        np.testing.assert_array_equal(
            look_back_scan(x, tile, rng, resident=100, windows=windows), want,
            err_msg=f"trial {trial}")
    assert max(windows) >= 2


@pytest.mark.parametrize("epoch_max", [3, EPOCH_MAX])
def test_look_back_reuses_one_scratch(epoch_max):
    """Launches of random sizes in turn on one scratch, never reset between
    them, each tile size chosen as the kernel chooses it (the small tile
    below one wave of the large one): a word of an earlier launch, of any
    value, never enters a sum. A small ``epoch_max`` makes the host clear
    the scratch now and then; the other run starts the ticket and its base
    just below the uint32 wrap."""
    rng = np.random.default_rng(epoch_max)
    small, big, waves = 2, 8, 6
    scratch = Scratch(64, epoch_max)
    if epoch_max == EPOCH_MAX:
        scratch.ticket = scratch.base = MASK - 40
    for launch in range(40):
        n = int(rng.integers(1, small * 63))
        tile = small if -(-n // big) < waves else big
        x = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
        want = t_ps.wrap_i32(torch.cumsum(torch.from_numpy(x).long(),
                                          0)).numpy()
        resident = int(rng.choice([1, 2, 5, 64]))
        np.testing.assert_array_equal(
            look_back_scan(x, tile, rng, resident, scratch=scratch), want,
            err_msg=f"launch {launch}, n {n}, tile {tile}")
    assert scratch.epoch == (39 % 3 + 1 if epoch_max == 3 else 40)
    assert (scratch.resets > 0) == (epoch_max == 3)
    if epoch_max == EPOCH_MAX:
        assert scratch.ticket < MASK - 40  # the ticket wrapped


def test_look_back_matches_the_plain_prefix_sum():
    x = np.random.default_rng(9).integers(0, 59, 3001).astype(np.int32)
    want = t_ps.prefix_sum_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        look_back_scan(x, 16, np.random.default_rng(0), resident=6), want)


# --- the float32 order ---------------------------------------------------------

def emulate_order_f32(x: np.ndarray, threads: int, items: int) -> np.ndarray:
    """``csrc/scan.cuh``'s float32 order, scalar by scalar in float32: the
    tile function over each tile, then over the tile totals in chunks of
    one tile with the carry chained, then carry + tile-local prefix."""
    tile = threads * items
    f32 = np.float32

    def tile_fn(vals):
        vals = np.concatenate([vals, np.zeros((-len(vals)) % tile, f32)])
        xs = vals.reshape(threads, items)
        loc = np.empty_like(xs)
        for t in range(threads):
            acc = xs[t, 0]
            loc[t, 0] = acc
            for i in range(1, items):
                acc = f32(acc + xs[t, i])
                loc[t, i] = acc
        incl = loc[:, -1].copy()
        d = 1
        while d < threads:
            nxt = incl.copy()
            for t in range(d, threads):
                nxt[t] = f32(incl[t] + incl[t - d])
            incl, d = nxt, d * 2
        pre = loc.copy()
        for t in range(1, threads):
            pre[t] = (incl[t - 1] + loc[t]).astype(f32)
        return pre.reshape(-1), incl[-1]

    nt = max(1, -(-len(x) // tile))
    pres, tots = zip(*(tile_fn(x[t * tile:(t + 1) * tile]) for t in range(nt)))
    tots = np.array(tots, f32)
    carry, carries = f32(0), [f32(0)]
    for c in range(0, nt, tile):
        pre2, tot2 = tile_fn(tots[c:c + tile])
        carries.extend((carry + pre2).astype(f32))
        carry = f32(carry + tot2)
    out = np.concatenate([(carries[t] + pres[t]).astype(f32)
                          for t in range(nt)])
    return out[:len(x)]


@pytest.mark.parametrize("threads,items", [(4, 2), (2, 4), (8, 1)])
@pytest.mark.parametrize("n", [1, 9, 64, 200, 777])
def test_order_f32_at_tiny_tiles(threads, items, n):
    x = np.random.default_rng(n).normal(size=n).astype(np.float32) * 1000
    got = t_ps.scan_order(torch.from_numpy(x), threads, items).numpy()
    np.testing.assert_array_equal(got, emulate_order_f32(x, threads, items))


@pytest.mark.parametrize("n", [9, 200, 777])
def test_prefix_sum_plain_takes_the_order(monkeypatch, n):
    monkeypatch.setattr(t_ps, "THREADS", 4)
    monkeypatch.setattr(t_ps, "ITEMS", 2)
    x = np.random.default_rng(n + 1).random(n).astype(np.float32) * 1000
    got = t_ps.prefix_sum_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, emulate_order_f32(x, 4, 2))


@pytest.mark.parametrize("acap", [1, 37, 500, 2049])
def test_arrivals_take_the_order(monkeypatch, acap):
    """The draw's arrivals: the same order at the draw's tile shape, then a
    running max."""
    monkeypatch.setattr(t_fd, "THREADS", 4)
    monkeypatch.setattr(t_fd, "ITEMS", 2)
    key = t_threefry.key(acap)
    u = t_threefry.uniforms_plain(key, acap, stream=0)
    gaps = (-torch.log1p(-u)).numpy()
    want = np.maximum.accumulate(emulate_order_f32(gaps, 4, 2))
    np.testing.assert_array_equal(t_fd.arrivals(key, acap, "cpu").numpy(),
                                  want)


def _defines(name: str) -> dict:
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"^#define (\w+) (\d+)\s*$", text, re.M)}


def test_tile_constants_are_the_kernels():
    scan, draw = _defines("scan.cu"), _defines("fused_draw.cu")
    assert (t_ps.THREADS, t_ps.ITEMS) == (scan["SC_THREADS"], scan["SC_ITEMS"])
    assert t_ps.TILE == t_ps.THREADS * t_ps.ITEMS
    assert t_ps.LOOK_BACK_TILE == scan["LB_THREADS"] * scan["LB_ITEMS"]
    assert t_ps.LOOK_BACK_SMALL_TILE == (scan["LB_THREADS"]
                                         * scan["LB_SMALL_ITEMS"])
    assert scan["LB_EPOCH_BITS"] == EPOCH_BITS
    assert (t_fd.THREADS, t_fd.ITEMS) == (draw["FD_THREADS"],
                                          draw["FD_ITEMS"])


# --- the wrapper's scratch, on a fake library ------------------------------------

def _fake_scan(monkeypatch, calls, rc=0):
    """``csrc/scan.cu`` as a fake library whose entries record the scratch
    (pointer, capacity) and host state each launch gets, and advance the
    state as ``lb_launch`` does."""
    def entry(name):
        def launch(*args):
            words, capacity, state = args[-4], args[-3], args[-2]
            calls.append((name, words, capacity, args[-1]))
            if rc == 0:
                state[0] += 1
            return rc
        return launch

    monkeypatch.setattr(build, "library", lambda name: types.SimpleNamespace(
        scan_i32_launch=entry("scan_i32"), geo_gaps_launch=entry("geo_gaps")))
    monkeypatch.setattr(build, "_ENTRIES", {})
    monkeypatch.setattr(t_ps, "_SCRATCH", {})
    stream = types.SimpleNamespace(cuda_stream=5)
    monkeypatch.setattr(build, "current_stream", lambda d: stream.cuda_stream)
    return stream


def test_scratch_is_made_once_per_stream_and_grown(monkeypatch):
    calls, zeros = [], []
    stream = _fake_scan(monkeypatch, calls)
    x, u = torch.zeros(5000, dtype=torch.int32), torch.rand(5000)
    out = torch.empty(5000, dtype=torch.int32)
    big = torch.zeros(70000, dtype=torch.int32)
    real_zeros = torch.zeros
    monkeypatch.setattr(torch, "zeros",
                        lambda *a, **k: zeros.append(a) or real_zeros(*a, **k))
    for _ in range(50):  # the two entries in turn on one scratch
        t_ps.scan_launch("scan_i32", x, out)
        t_ps.scan_launch("geo_gaps", u, out, t_geo.clip_p(0.05))
    assert len(zeros) == 1 and {c[0] for c in calls} == {"scan_i32",
                                                         "geo_gaps"}
    assert len({(c[1], c[2]) for c in calls}) == 1
    need = -(-5000 // t_ps.LOOK_BACK_SMALL_TILE) + 1
    assert calls[0][2] == 1 << (need - 1).bit_length() >= need
    (scratch,) = t_ps._SCRATCH.values()
    assert scratch.state[0] == 100  # every launch took the next epoch
    t_ps.scan_launch("scan_i32", big, torch.empty_like(big))
    assert len(zeros) == 2 and calls[-1][2] >= -(-70000 // 2048) + 1
    t_ps.scan_launch("scan_i32", x, out)  # the grown scratch serves it
    assert len(zeros) == 2 and calls[-1][1] == calls[-2][1]
    stream.cuda_stream = 9  # another stream, another scratch
    t_ps.scan_launch("scan_i32", x, out)
    assert len(zeros) == 3 and calls[-1][3] == 9
    assert len(t_ps._SCRATCH) == 2


def test_a_refused_launch_drops_the_scratch(monkeypatch):
    calls = []
    _fake_scan(monkeypatch, calls, rc=700)
    x = torch.zeros(100, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="scan_i32: CUDA error 700"):
        t_ps.scan_launch("scan_i32", x, torch.empty_like(x))
    assert t_ps._SCRATCH == {}


# --- the float64 order: the engine's mass prefix --------------------------------

def emulate_order_vectorized(x: np.ndarray, threads: int,
                             items: int) -> np.ndarray:
    """``csrc/scan.cuh``'s order in x's own type, vectorized over tiles and
    threads with numpy: each thread's items in sequence, the thread totals
    Hillis-Steele, the tile totals the same in chunks of one tile with the
    carry chained, an element its tile's carry + its tile-local prefix."""
    tile = threads * items
    dt = x.dtype.type

    def tiles(v):
        nt = max(1, -(-len(v) // tile))
        xs = np.concatenate([v, np.zeros(nt * tile - len(v), v.dtype)])
        xs = xs.reshape(nt, threads, items)
        loc = np.empty_like(xs)
        loc[:, :, 0] = xs[:, :, 0]
        for i in range(1, items):
            loc[:, :, i] = loc[:, :, i - 1] + xs[:, :, i]
        incl = loc[:, :, -1].copy()
        d = 1
        while d < threads:
            nxt = incl.copy()
            nxt[:, d:] = incl[:, d:] + incl[:, :-d]
            incl, d = nxt, d * 2
        pre = loc.copy()
        pre[:, 1:, :] = incl[:, :-1, None] + loc[:, 1:, :]
        return pre.reshape(nt, tile), incl[:, -1]

    pre, tot = tiles(x)
    carry, carries = dt(0), [np.zeros(1, x.dtype)]
    for c in range(0, len(tot), tile):
        pre2, tot2 = tiles(tot[c:c + tile])
        carries.append(carry + pre2.reshape(-1)[:len(tot[c:c + tile])])
        carry = dt(carry + tot2[0])
    carries = np.concatenate(carries)[:len(tot)]
    return (carries[:, None] + pre).reshape(-1)[:len(x)]


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 2_528_313])
def test_float64_scan_takes_the_fixed_order(n):
    """The float64 instance's plain version (what the kernel is held to on
    the card) sums in the kernel's order at 256 x 16, bit for bit, at one
    element, around one tile and at A's R + 1 (2,528,313: many tiles, one
    chunk of carries); and stays within rounding of a float64 cumsum."""
    x = np.random.default_rng(n).random(n) * np.random.default_rng(
        n + 1).integers(1, 50, n)
    want = emulate_order_vectorized(x, t_ps.THREADS, t_ps.ITEMS)
    got = t_ps.prefix_sum_tiles(torch.from_numpy(x))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        t_ps.scan_order(torch.from_numpy(x), t_ps.THREADS, t_ps.ITEMS).numpy(),
        want)
    assert np.abs(want - np.cumsum(x)).max() <= 1e-12 * np.cumsum(x)[-1]


@pytest.mark.parametrize("n", [9, 200, 777])
def test_float64_order_at_tiny_tiles(n):
    x = np.random.default_rng(n).normal(size=n) * 1000
    got = t_ps.scan_order(torch.from_numpy(x), 4, 2).numpy()
    np.testing.assert_array_equal(got, emulate_order_vectorized(x, 4, 2))
    # the vectorized emulation is the scalar one's order
    x32 = x.astype(np.float32)
    np.testing.assert_array_equal(emulate_order_vectorized(x32, 4, 2),
                                  emulate_order_f32(x32, 4, 2))


def test_mass_prefix_is_the_fixed_order_either_way():
    from repro_torch.config import KernelPolicy
    from repro_torch.core import sampling as t_sampling

    x = torch.from_numpy(np.random.default_rng(3).random(10_000))
    want = torch.cat([torch.zeros(1, dtype=torch.float64),
                      t_ps.scan_order(x, t_ps.THREADS, t_ps.ITEMS)])
    for policy in (KernelPolicy(), KernelPolicy(enabled=False)):
        got = t_sampling.mass_prefix(x, policy)
        assert torch.equal(got, want)


def test_pernode_draws_repeat_under_a_key():
    """Two per-node draws of one key, and two plans' fused-draw tables, are
    equal (on the card the library scan they used to take was not)."""
    from repro_torch.core import sampling as t_sampling
    from test_torch_engine import PREFER, engines
    from test_torch_kernels import star_chain

    tables, q = star_chain(5, n_t=60)
    _, port, tq = engines(tables, q)
    assert port.compile(tq).route == "pernode"
    for seed in range(3):
        a = port.sample(tq, t_threefry.key(seed))
        b = port.sample(tq, t_threefry.key(seed))
        assert torch.equal(a.positions, b.positions)
        assert int(a.count) == int(b.count)
        for v in a.columns:
            assert torch.equal(a.columns[v], b.columns[v])
    plan = port.compile(tq)
    one = t_sampling.fused_draw_params(plan.w, plan.p, plan.prefE)
    two = t_sampling.fused_draw_params(plan.w, plan.p, plan.prefE, PREFER)
    assert all(torch.equal(one[k], two[k]) for k in one)


# --- the floats in one launch: the carry from the published totals ----------------

def hillis_steele(v: torch.Tensor) -> torch.Tensor:
    """``sc_block_excl``'s inclusive scan of one value a thread."""
    d = 1
    while d < v.shape[0]:
        v = torch.cat([v[:d], v[d:] + v[:-d]])
        d *= 2
    return v


def sequential(v: torch.Tensor) -> torch.Tensor:
    """A thread's items added in sequence: the last running sum."""
    acc = v[0]
    for x in v[1:]:
        acc = acc + x
    return acc


def carry_at(published: torch.Tensor, threads: int, items: int):
    """``csrc/scan.cu`` ``sc_carry_at`` as torch ops: the carry of tile
    ``t = len(published)`` from the totals of tiles 0 .. t - 1. Total
    t - 1 is item iq of thread q of chunk c (chunks of ``threads`` groups
    of ``items`` totals). The group sums (each group's totals in sequence,
    ``sc_publish_group``) before q go through one Hillis-Steele scan with
    the sums from q on as 0; thread q adds its own items 0 .. iq in
    sequence after that prefix; the chained carry of the earlier chunks
    (each chunk's Hillis-Steele total of its group sums) goes in front."""
    tile = threads * items
    t = published.shape[0]
    zero = torch.zeros((), dtype=published.dtype)
    if t == 0:
        return zero
    groups = [sequential(published[g * items:(g + 1) * items])
              for g in range(t // items)]  # the complete groups
    last = t - 1
    c, p = divmod(last, tile)
    q, iq = divmod(p, items)
    chained = zero
    for k in range(c):
        chained = chained + hillis_steele(
            torch.stack(groups[k * threads:(k + 1) * threads]))[-1]
    before = groups[c * threads:c * threads + q]
    sums = torch.stack(before + [zero] * (threads - q))
    loc = sequential(published[c * tile + q * items:t])
    value = loc if q == 0 else hillis_steele(sums)[q - 1] + loc
    return chained + value


def one_launch(x: torch.Tensor, threads: int, items: int, order) -> torch.Tensor:
    """The float scan as one launch: tiles finish their own scan in
    ``order`` (any permutation) and publish their totals; a tile's carry
    is computed from the totals before it alone (``carry_at``: in the
    kernel from the group sums that the last tile of each group publishes,
    the same values); an element is carry + its tile-local prefix."""
    tile = threads * items
    n = x.shape[0]
    nt = -(-n // tile)
    pre, tot = t_ps._tiles(x, threads, items)
    published = {}
    carries = {}
    pending = list(order)
    while pending:
        t = pending.pop(0)
        published[t] = tot[t]
        # every tile whose predecessors have all published takes its carry
        for u in range(nt):
            if u not in carries and all(v in published for v in range(u)):
                seen = torch.stack([published[v] for v in range(u)]) \
                    if u else tot[:0]
                carries[u] = carry_at(seen, threads, items)
    out = torch.stack([carries[t] + pre[t] for t in range(nt)])
    return out.reshape(-1)[:n]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("threads,items,n", [
    (4, 2, 1), (4, 2, 63), (4, 2, 8 * 8),          # one chunk of totals
    (4, 2, 8 * 8 + 1), (4, 2, 8 * 8 * 3 + 5),     # two and four chunks
    (2, 4, 333), (8, 1, 200)])
def test_one_launch_protocol_equals_the_order(dtype, threads, items, n):
    """Tiles finishing in a random order, each carry recomputed from the
    published totals before it: ``scan_order``'s bits."""
    rng = np.random.default_rng(n + threads)
    x = torch.from_numpy(rng.normal(size=n) * 1000).to(dtype)
    nt = -(-n // (threads * items))
    got = one_launch(x, threads, items, rng.permutation(nt).tolist())
    want = t_ps.scan_order(x, threads, items)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)


def test_carry_at_is_the_chunked_scan_of_the_totals():
    """Each tile's carry equals ``scan_order``'s carries: the exclusive
    chunked scan of the tile totals, at every tile of four chunks."""
    rng = np.random.default_rng(5)
    tot = torch.from_numpy(rng.normal(size=8 * 4 + 3) * 1e6)
    incl = t_ps.scan_order(tot, 4, 2)
    for t in range(tot.shape[0] + 1):
        want = incl[t - 1] if t else torch.zeros((), dtype=tot.dtype)
        assert torch.equal(carry_at(tot[:t], 4, 2), want), t


def _fake_float_scan(monkeypatch, calls):
    """``csrc/scan.cu``'s four entries as a fake library that records the
    scratch (pointer, capacity) of each launch and advances the host
    state as ``lb_run`` does."""
    def entry(name):
        def launch(*args):
            words, capacity, state = args[-4], args[-3], args[-2]
            calls.append((name, words, capacity, args[-1]))
            state[0] += 1
            return 0
        return launch

    monkeypatch.setattr(build, "library", lambda name: types.SimpleNamespace(
        **{f"{e}_launch": entry(e) for e in ("scan_i32", "geo_gaps",
                                              "scan_f32", "scan_f64")}))
    monkeypatch.setattr(build, "_ENTRIES", {})
    monkeypatch.setattr(t_ps, "_SCRATCH", {})
    monkeypatch.setattr(build, "current_stream", lambda d: 5)


def test_float_entries_take_the_cached_scratch(monkeypatch):
    """The float scans allocate nothing per call: they share the
    look-back's scratch of the stream, grown (a power of two words) only
    when a launch needs more words than it holds: two a tile of
    ``TILE`` for float64, one for float32, the ticket's word besides."""
    calls, made = [], []
    _fake_float_scan(monkeypatch, calls)
    x64 = torch.rand(10_000, dtype=torch.float64)
    x32 = x64.float()
    x_i = torch.zeros(10_000, dtype=torch.int32)
    outs = (torch.empty_like(x64), torch.empty_like(x32),
            torch.empty_like(x_i))
    real = {f: getattr(torch, f) for f in ("zeros", "empty", "empty_like")}
    for f, fn in real.items():
        monkeypatch.setattr(torch, f, lambda *a, _fn=fn, _f=f, **k:
                            made.append(_f) or _fn(*a, **k))
    for _ in range(20):
        t_ps.scan_launch("scan_f64", x64, outs[0])
        t_ps.scan_launch("scan_f32", x32, outs[1])
        t_ps.scan_launch("scan_i32", x_i, outs[2])
    assert made == ["zeros"]  # the one scratch, made by the first call
    assert len({(c[1], c[2]) for c in calls}) == 1
    need = max(t_ps._words_needed(e, 10_000)
               for e in ("scan_f64", "scan_f32", "scan_i32"))
    assert need == 2 * (3 + 1) + 1  # float64: 3 tiles' totals, a group sum
    assert calls[0][2] == 1 << (need - 1).bit_length()
    (scratch,) = t_ps._SCRATCH.values()
    assert scratch.state[0] == 60  # one epoch a launch, any entry
    big = torch.rand(5 * 2**20, dtype=torch.float64)
    t_ps.scan_launch("scan_f64", big, torch.empty(0))
    assert made.count("zeros") == 2
    assert calls[-1][2] >= 2 * -(-big.numel() // t_ps.TILE) + 1


@pytest.mark.parametrize("entry,n,want", [
    ("scan_f64", 1, 2 * (1 + 1) + 1), ("scan_f64", 4096, 5),
    ("scan_f64", 4097, 2 * (2 + 1) + 1), ("scan_f32", 4097, 4),
    ("scan_i32", 4097, 4), ("geo_gaps", 2048, 2),
    ("scan_f64", 2_528_312, 2 * (618 + 39) + 1),
    ("scan_f32", 36_244_344, 8849 + 554 + 1)])
def test_words_needed(entry, n, want):
    """A word a 32 bits of each tile total and each group sum (``ITEMS``
    totals), the ticket's word besides; a word a tile of the look-back."""
    assert t_ps._words_needed(entry, n) == want
