"""What the CPU can show of the float32 attention kernels
(``csrc/flash_prefill.cu``, ``csrc/flash_decode.cu``
``flash_decode_f32_kernel``), which run only on the card:

  * their arithmetic, emulated in torch: prefill's work items of
    ``TILE_Q`` rows, its warps' key blocks of each tile with their own
    online softmax in base 2 (the scale times log2 e folded into the
    scores, the -1e30 mask and initial max in base 2) and the key warps'
    merge; decode's ``decode_splits_f32`` splits, each warp's keys of every
    ring stage with its own online softmax for all G heads, the warps'
    merge, and the in-launch merge of the splits in split order. Each
    emulation is held against the port's plain version and, at the ragged
    S, against the JAX reference's Pallas kernels in interpret mode, at the
    float32 tolerances of ``chip_smoke.py`` (``F32_PREFILL_TOL``,
    ``F32_DECODE_TOL``);
  * the prefill kernel's ticket order (``flash_prefill.work_order``) and
    the float32 decode split choice (``flash_decode.decode_splits_f32``);
  * that the Python mirrors of the kernels' tiles are the sources' own.

On the card ``chip_smoke.py`` (phase D) holds each kernel against its plain
version at the same tolerances.
"""
import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import flash_decode as r_fd
from repro.kernels import flash_prefill as r_fp
from repro_torch.kernels import build
from repro_torch.kernels import flash_decode as t_fd
from repro_torch.kernels import flash_prefill as t_fp

PREFILL_TOL = (2e-4, 2e-4)  # (rtol, atol): chip_smoke.F32_PREFILL_TOL
DECODE_TOL = (2e-5, 2e-5)   # chip_smoke.F32_DECODE_TOL
LOG2E = np.float32(1.4426950408889634)
NEG2 = float(np.float32(-1e30) * LOG2E)  # -1e30 in base 2
SEQS = [1, 63, 64, 65, 1000]
# the ragged S run through the reference in interpret mode as well (the
# others against the plain version only: the file stays under ~20 s)
JAX_SEQS = (63, 65)


def _close(got, want, tol) -> None:
    """assert |got - want| <= atol + rtol |want| everywhere."""
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = want.numpy() if isinstance(want, torch.Tensor) else np.asarray(want)
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, w, rtol=tol[0], atol=tol[1])


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32) for s in shapes]
    return [torch.from_numpy(a) for a in arrays], [jnp.asarray(a)
                                                   for a in arrays]


# --- prefill ----------------------------------------------------------------------

def _online(state, x, vb):
    """One block of an online softmax in base 2: x (rows, keys) already in
    base 2, vb (keys, D)."""
    m, l, acc = state
    m_new = torch.maximum(m, x.amax(-1, keepdim=True))
    alpha = torch.exp2(m - m_new)
    p = torch.exp2(x - m_new)
    return m_new, l * alpha + p.sum(-1, keepdim=True), acc * alpha + p @ vb


def prefill_f32_emulated(q, k, v, causal: bool, shape=None):
    """flash_prefill.cu's arithmetic on float32 q (B, H, S, D), k/v (B, KV,
    S, D): items of TILE_Q query rows; within an item each warp owns its
    rows and its key block of every tile of BK keys (``shape``, an
    ``F32_INSTANCES`` value; ``F32_SHAPES[D]`` by default), skips
    blocks past S or wholly above its rows, and keeps its own online
    softmax: scores times c = scale log2 e, -1e30 above the diagonal and
    -inf past S where a block needs a mask; without one, the raw max times
    c and p = 2^(s c - m). Two key warps of a row set merge at the end."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    G = H // KV
    row_warps, key_warps, bk = shape or t_fp.F32_SHAPES[D]
    rw_rows, kw_keys = t_fp.TILE_Q // row_warps, bk // key_warps
    c = float(np.float32(np.float32(1.0 / D ** 0.5) * LOG2E))
    out = torch.empty((B, H, S, D), dtype=torch.float32)
    for tile, h, b in t_fp.work_order(S, H, B):
        q0 = tile * t_fp.TILE_Q
        k_end = min(S, q0 + t_fp.TILE_Q) if causal else S
        kf, vf = k[b, h // G], v[b, h // G]
        for rw in range(row_warps):
            r0 = q0 + rw * rw_rows
            r1 = min(S, r0 + rw_rows)
            if r0 >= S:
                continue
            rows = torch.arange(r0, r1)[:, None]
            states = []
            for kw in range(key_warps):
                st = (torch.full((r1 - r0, 1), NEG2),
                      torch.zeros((r1 - r0, 1)), torch.zeros((r1 - r0, D)))
                for t in range(-(-k_end // bk)):
                    key0 = t * bk + kw * kw_keys
                    last = r0 + rw_rows - 1
                    if key0 >= S or (causal and key0 > last):
                        continue
                    keys = torch.arange(key0, key0 + kw_keys)
                    kb = kf[key0:key0 + kw_keys]
                    vb = torch.zeros((kw_keys, D))
                    vb[:kb.shape[0]] = vf[key0:key0 + kw_keys]
                    s = torch.zeros((r1 - r0, kw_keys))
                    s[:, :kb.shape[0]] = q[b, h, r0:r1] @ kb.T
                    if key0 + kw_keys > S or (causal and
                                              key0 + kw_keys - 1 > r0):
                        x = s * c
                        x = torch.where(keys[None] >= S, -math.inf,
                                        torch.where(causal & (keys[None] > rows),
                                                    NEG2, x))
                        st = _online(st, x, vb)
                    else:
                        m, l, acc = st
                        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
                        alpha = torch.exp2(m - m_new)
                        p = torch.exp2(s * c - m_new)
                        st = (m_new, l * alpha + p.sum(-1, keepdim=True),
                              acc * alpha + p @ vb)
                states.append(st)
            m, l, acc = states[0]
            if key_warps == 2:
                (m1, l1, a1) = states[1]
                mm = torch.maximum(m, m1)
                f0, f1 = torch.exp2(m - mm), torch.exp2(m1 - mm)
                l, acc = f0 * l + f1 * l1, f0 * acc + f1 * a1
            out[b, h, r0:r1] = acc / torch.clamp(l, min=1e-30)
    return out


# (H, KV) of each instance: smollm-135m's (9, 3), llama3's G = 16 over one
# KV head at 128, gemma3-1b's (4, 1) at 256
PREFILL_WIDTHS = {64: (9, 3), 128: (16, 1), 256: (4, 1)}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("D", [64, 128, 256])
def test_prefill_f32_numerics(D, S, causal):
    H, KV = PREFILL_WIDTHS[D]
    if S == 1000:  # the long rows: fewer heads, for time
        H, KV = (3, 1) if D == 64 else (2, 1)
    (q, k, v), (rq, rk, rv) = _inputs(
        [(1, H, S, D), (1, KV, S, D), (1, KV, S, D)], 7 * S + D)
    got = prefill_f32_emulated(q, k, v, causal)
    _close(got, t_fp.flash_prefill_plain(q, k, v, causal), PREFILL_TOL)
    if S in JAX_SEQS:
        want = r_fp.flash_prefill(rq, rk, rv, causal=causal, block_q=S,
                                  block_k=S, interpret=True)
        _close(got, np.asarray(want, np.float32), PREFILL_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S,H,B", [(1, 1, 1), (64, 9, 2), (65, 9, 2),
                                   (1000, 9, 2), (1000, 3, 1)])
def test_work_order_covers_each_item_once_heaviest_first(S, H, B, causal):
    order = t_fp.work_order(S, H, B)
    T = -(-S // t_fp.TILE_Q)
    assert sorted(order) == [(t, h, b) for t in range(T) for h in range(H)
                             for b in range(B)]
    for D, (_, _, bk) in t_fp.F32_SHAPES.items():
        keys = [min(S, (t + 1) * t_fp.TILE_Q) if causal else S
                for t, _, _ in order]
        walked = [-(-n // bk) for n in keys]
        assert walked == sorted(walked, reverse=True), D


# --- decode ----------------------------------------------------------------------

def decode_f32_emulated(q, k, v, bias, nsplit: int):
    """flash_decode.cu's float32 arithmetic: each split's keys in ring
    stages of ``F32_TILE_KEYS[D]`` keys, each of the ``F32_WARPS`` warps
    with its slice of every stage and its own online softmax in base 2
    over all G heads, (dot * scale + bias) * log2 e; the warps merged in
    the block, the splits merged in split order (m in base 2)."""
    B, H, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    G = H // KVH
    tk = t_fd.F32_TILE_KEYS[D]
    kpw = tk // t_fd.F32_WARPS
    scale = np.float32(1.0 / D ** 0.5)
    out = torch.empty((B, H, D), dtype=torch.float32)
    for b in range(B):
        for j in range(KVH):
            qf = q[b, j * G:(j + 1) * G]
            kf, vf = k[b, j], v[b, j]
            parts = []
            for s0, s1 in t_fd.split_bounds(S, nsplit):
                warps = []
                for w in range(t_fd.F32_WARPS):
                    st = (torch.full((G, 1), NEG2), torch.zeros((G, 1)),
                          torch.zeros((G, D)))
                    for k0 in range(s0, s1, tk):
                        a, e = k0 + w * kpw, min(s1, k0 + (w + 1) * kpw)
                        if a >= e:
                            continue
                        x = ((qf @ kf[a:e].T) * float(scale)
                             + bias[b, a:e]) * float(LOG2E)
                        st = _online(st, x, vf[a:e])
                    warps.append(st)
                mx = torch.stack([w_[0] for w_ in warps]).amax(0)
                f = [torch.exp2(w_[0] - mx) for w_ in warps]
                parts.append((mx, sum(fi * w_[1] for fi, w_ in zip(f, warps)),
                              sum(fi * w_[2] for fi, w_ in zip(f, warps))))
            mx = torch.stack([p_[0] for p_ in parts]).amax(0)
            num, den = torch.zeros((G, D)), torch.zeros((G, 1))
            for p_ in parts:  # in split order
                e = torch.exp2(p_[0] - mx)
                num, den = num + e * p_[2], den + e * p_[1]
            out[b, j * G:(j + 1) * G] = num / torch.clamp(den, min=1e-30)
    return out


def _bias(B, S, seed, masked_row=None):
    """0 on each row's first keys (a padded cache: lengths in [S/2, S]),
    -1e30 after; ``masked_row`` at -1e30 everywhere."""
    lens = np.random.default_rng(seed).integers(max(1, S // 2), S + 1, B)
    bias = np.where(np.arange(S)[None] < lens[:, None], 0.0,
                    -1e30).astype(np.float32)
    if masked_row is not None:
        bias[masked_row] = -1e30
    return bias


def _splits(B, KVH, G, S):
    return t_fd.decode_splits_f32(B * KVH, S, 132, G)


@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("G,D", [(1, 64), (4, 128), (16, 256), (16, 128),
                                 (4, 64)])
def test_decode_f32_numerics(G, D, S):
    B, KVH = 2, 2
    (q, k, v), (rq, rk, rv) = _inputs(
        [(B, G * KVH, D), (B, KVH, S, D), (B, KVH, S, D)], 13 * S + G + D)
    bias = _bias(B, S, S)
    tb = torch.from_numpy(bias)
    got = decode_f32_emulated(q, k, v, tb, _splits(B, KVH, G, S))
    _close(got, t_fd.flash_decode_plain(q, k, v, tb), DECODE_TOL)
    if S in JAX_SEQS:
        want = r_fd.flash_decode(rq, rk, rv, jnp.asarray(bias), block_s=S,
                                 interpret=True)
        _close(got, np.asarray(want, np.float32), DECODE_TOL)


@pytest.mark.parametrize("S", [65, 1000])
def test_decode_f32_row_masked_everywhere_averages_v(S):
    """A bias row of -1e30 at every key: as in the reference, the softmax
    is uniform and the output is V's mean, not NaN, across the splits, the
    warps' slices and the in-launch merge."""
    B, KVH, G, D = 2, 1, 16, 128
    (q, k, v), (rq, rk, rv) = _inputs(
        [(B, G * KVH, D), (B, KVH, S, D), (B, KVH, S, D)], 3 + S)
    bias = _bias(B, S, 1, masked_row=0)
    tb = torch.from_numpy(bias)
    nsplit = _splits(B, KVH, G, S)
    assert nsplit > 1
    got = decode_f32_emulated(q, k, v, tb, nsplit)
    _close(got[0], v[0, 0].mean(0).expand(G, D), DECODE_TOL)
    _close(got, t_fd.flash_decode_plain(q, k, v, tb), DECODE_TOL)
    if S in JAX_SEQS:
        _close(got, np.asarray(r_fd.flash_decode(
            rq, rk, rv, jnp.asarray(bias), block_s=S, interpret=True),
            np.float32), DECODE_TOL)


@pytest.mark.parametrize("rows,S,sms,group", [
    (4, 4096, 132, 4),       # phase D's float32 case
    (4, 32768, 132, 4),
    (128, 32768, 132, 16),
    (1, 1000, 132, 64),
    (2, 65, 132, 1),
    (2, 31, 132, 1),
    (1, 1, 132, 1),
    (6, 70000, 8, 8),
])
def test_decode_splits_f32(rows, S, sms, group):
    n = t_fd.decode_splits_f32(rows, S, sms, group)
    bounds = t_fd.split_bounds(S, n)
    assert bounds[0][0] == 0 and bounds[-1][1] == S
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    lengths = [e - s for s, e in bounds]
    assert min(lengths) >= 1
    if S >= t_fd.MIN_SPLIT_F32:
        assert min(lengths) >= t_fd.MIN_SPLIT_F32
    assert group * n <= t_fd.MERGE_WORDS
    cap = min(S // t_fd.MIN_SPLIT_F32, t_fd.MERGE_WORDS // group)
    if rows * cap >= 2 * sms:
        assert rows * n >= 2 * sms  # two blocks on every SM
    if (rows, S, sms) == (4, 4096, 132):
        assert max(lengths) <= 64


# --- the mirrors of the sources --------------------------------------------------

def _source(name: str) -> str:
    return (build.CSRC / name).read_text()


def test_mirrors_match_the_sources():
    pre = _source("flash_prefill.cu")
    assert re.search(r"#define FP_BQ (\d+)", pre).group(1) == str(t_fp.TILE_Q)
    # every instance FpShape<D, BK>; the first at each D is its builtin
    found = [((int(d), int(bk)), tuple(int(x) for x in v))
             for d, bk, *v in re.findall(
        r"struct FpShape<(\d+), (\d+)> \{\s*static constexpr int "
        r"ROW_WARPS = (\d+), KEY_WARPS = (\d+), BK = (\d+);", pre)]
    assert dict(found) == t_fp.F32_INSTANCES
    assert all(shape[2] == bk for (_, bk), shape in found)
    builtin = {}
    for (d, _), shape in found:
        builtin.setdefault(d, shape)
    assert builtin == t_fp.F32_SHAPES
    dec = _source("flash_decode.cu")
    assert re.search(r"#define FD_WARPS (\d+)", dec).group(1) == str(
        t_fd.F32_WARPS)
    assert re.search(r"#define FD_MERGE_WORDS (\d+)", dec).group(1) == str(
        t_fd.MERGE_WORDS)
    assert ("static constexpr int TK =\n      4096 / D < 32 * FD_WARPS ? "
            "4096 / D : 32 * FD_WARPS;") in dec
    assert t_fd.F32_TILE_KEYS == {D: min(4096 // D, 32 * t_fd.F32_WARPS)
                                  for D in t_fd.HEAD_DIMS[torch.float32]}
    assert t_fd.MAX_GROUP_WIDTH == 128 * int(
        re.search(r"#define FD_LARGE (\d+)", dec).group(1))
