"""The two scan designs of the port's CUDA kernels, checked on the CPU.

  * The int32 prefix sum's single-pass decoupled look-back
    (``csrc/scan.cu``): a Python model of its protocol (an atomic ticket
    per tile, 64-bit status words holding an aggregate or an inclusive
    prefix, one warp looking back 32 predecessors at a time) run under many
    random interleavings and residencies. Every run must equal
    ``wrap_i32(cumsum)`` exactly, across ragged sizes, more than 32 tiles
    (the look-back crosses several windows) and uint32 wrap.
  * The one float32 order function (``prefix_sum.scan_order_f32``) at tiny
    tile constants, for both of its users: the float32 prefix sum and the
    fused draw's arrivals. Each is held bit for bit against a scalar numpy
    emulation of ``csrc/scan.cuh``'s tile function and chunked carries.
  * The Python tile constants are the CUDA sources' own.

On the card ``chip_smoke.py`` holds the kernels themselves against these
plain versions.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import fused_draw as t_fd
from repro_torch.kernels import prefix_sum as t_ps
from repro_torch.kernels import threefry as t_threefry

CSRC = Path(t_ps.__file__).resolve().parent / "csrc"
MASK = (1 << 32) - 1
AGGREGATE, PREFIX = 1, 2
WINDOW = 32  # lanes of the looking-back warp


# --- the look-back protocol -----------------------------------------------------

def look_back_scan(x: np.ndarray, tile: int, rng, resident: int,
                   windows=None) -> np.ndarray:
    """``csrc/scan.cu``'s int32 scan as a protocol among tile blocks,
    interleaved at random. At most ``resident`` blocks run at once (a block
    leaves when it has written its tile); a block draws its tile from the
    ticket when it first runs. Every shared read or write is its own
    step, and the looking-back warp reads its 32 words one lane at a time in
    random order, each lane spinning until its word is published. The
    number of windows each block read is appended to ``windows``."""
    n = x.shape[0]
    nt = -(-n // tile)
    xu = x.astype(np.int64) & MASK
    status = [0] * nt
    ticket = [0]
    out = np.zeros(n, np.int64)

    def block():
        t = ticket[0]
        ticket[0] += 1
        yield
        local = np.cumsum(xu[t * tile:(t + 1) * tile]) & MASK
        agg = int(local[-1])
        excl = 0
        if t > 0:
            status[t] = (AGGREGATE << 32) | agg
            yield
            top, read = t - 1, 0
            while True:
                read += 1
                words, pending = {}, list(range(WINDOW))
                while pending:
                    lane = pending[rng.integers(len(pending))]
                    j = top - lane
                    w = PREFIX << 32 if j < 0 else status[j]
                    if w >> 32:
                        words[lane] = w
                        pending.remove(lane)
                    yield
                prefixes = [l for l in range(WINDOW) if words[l] >> 32 == PREFIX]
                stop = prefixes[0] if prefixes else WINDOW - 1
                excl = (excl + sum(words[l] & MASK
                                   for l in range(stop + 1))) & MASK
                if prefixes:
                    break
                top -= WINDOW
            if windows is not None:
                windows.append(read)
        status[t] = (PREFIX << 32) | ((excl + agg) & MASK)
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
    assert all(w >> 32 == PREFIX for w in status)
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
    assert (t_fd.THREADS, t_fd.ITEMS) == (draw["FD_THREADS"],
                                          draw["FD_ITEMS"])
