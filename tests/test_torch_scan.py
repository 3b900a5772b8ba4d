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
  * The one float32 order function (``prefix_sum.scan_order_f32``) at tiny
    tile constants, for both of its users: the float32 prefix sum and the
    fused draw's arrivals. Each is held bit for bit against a scalar numpy
    emulation of ``csrc/scan.cuh``'s tile function and chunked carries.
  * The Python tile constants are the CUDA sources' own.

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
    got = t_ps.scan_order_f32(torch.from_numpy(x), threads, items).numpy()
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
