"""What the CPU can show of the bf16 tensor-core attention kernels
(``csrc/flash_prefill_tc.cu``, ``csrc/flash_decode.cu``
``flash_decode_tc_kernel``), which run only on the card:

  * their numerics, emulated in torch: per-tile online softmax in base 2 at
    the kernels' tiles, bf16 operands with float32 products, P rounded for
    the P . V product as hi + lo (two bf16 terms), the row sum l from the
    float32 p; decode also in the kernel's splits and per-warp key slices.
    The emulation is held at ``BF16_TOL`` against the float32 oracle (the
    port's plain version) and the JAX reference's Pallas kernels in
    interpret mode. A single bf16 P breaks that tolerance on short causal
    rows, which is why the kernels split it;
  * the decode split choice (``flash_decode.decode_splits``);
  * dispatch: bf16 asks ``build.library`` for the tensor-core entry and
    float32 for the CUDA-core one, and neither falls back to the other.

On the card ``chip_smoke.py`` (phase D) holds each kernel against its plain
version at the same tolerance.
"""
import contextlib
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import flash_decode as r_fd
from repro.kernels import flash_prefill as r_fp
from repro_torch.kernels import build
from repro_torch.kernels import flash_decode as t_fd
from repro_torch.kernels import flash_prefill as t_fp

# bf16 outputs: one bf16 ulp (<= 2^-7 relative) plus a float32 margin.
BF16_TOL = (1e-2, 1e-3)
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)
NEG = np.float32(-1e30)
# The kernels' tiles: FptShape<D>::BK (prefill), FDT_TK and its four warps'
# slices (decode).
PREFILL_BK = {64: 128, 128: 128, 256: 64}
DECODE_TK, DECODE_WARPS = 64, 4
# (H, KV, D) of each instance: smollm-135m, llama3-405b's G = 16 over one
# KV head, gemma3-1b.
WIDTHS = {64: (9, 3), 128: (16, 1), 256: (4, 1)}
SEQS = [1, 63, 64, 65, 127, 128, 129, 1000]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol=BF16_TOL) -> float:
    """assert |got - want| <= atol + rtol |want|; returns the worst share
    of the bound."""
    g, w = _f32(got), _f32(want)
    assert np.isfinite(g).all()
    share = float(np.max(np.abs(g - w) / (tol[1] + tol[0] * np.abs(w))))
    assert share <= 1.0, share
    return share


def _pv(p, v, split: bool):
    """p . v with p rounded to bf16 as the kernels feed it: hi + lo, or a
    single bf16 term."""
    hi = p.to(torch.bfloat16).to(torch.float32)
    out = hi @ v
    if split:
        out = out + (p - hi).to(torch.bfloat16).to(torch.float32) @ v
    return out


def prefill_tc_emulated(q, k, v, causal: bool, split: bool = True):
    """flash_prefill_tc.cu's arithmetic on bf16 q (B, H, S, D), k/v (B, KV,
    S, D): key tiles of BK, scores s * (scale log2 e), the causal mask at
    -1e30 in base 2, keys past S at -inf, m from -1e30, out = acc / max(l,
    1e-30) in bf16. (On tiles without a mask the kernel rounds s c - m once,
    in one FFMA, where this rounds s c first: a float32 ulp of the
    exponent, far below the bf16 tolerance.)"""
    B, H, S, D = q.shape
    KV = k.shape[1]
    G, bk = H // KV, PREFILL_BK[D]
    sl2 = float(np.float32(np.float32(1.0 / D ** 0.5) * LOG2E))
    neg = float(NEG * LOG2E)
    rows = torch.arange(S)[:, None]
    out = torch.empty((B, H, S, D), dtype=torch.float32)
    for b in range(B):
        for j in range(KV):
            heads = slice(j * G, (j + 1) * G)
            qf = q[b, heads].float()
            kf, vf = k[b, j].float(), v[b, j].float()
            m = torch.full((G, S, 1), neg)
            l = torch.zeros((G, S, 1))
            acc = torch.zeros((G, S, D))
            for k0 in range(0, S, bk):
                x = (qf @ kf[k0:k0 + bk].T) * sl2
                if causal:
                    x = torch.where(torch.arange(k0, min(S, k0 + bk))[None]
                                    <= rows, x, neg)
                m_new = torch.maximum(m, x.amax(-1, keepdim=True))
                alpha = torch.exp2(m - m_new)
                p = torch.exp2(x - m_new)
                l = l * alpha + p.sum(-1, keepdim=True)
                acc = acc * alpha + _pv(p, vf[k0:k0 + bk], split)
                m = m_new
            out[b, heads] = acc / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def decode_tc_emulated(q, k, v, bias, nsplit: int):
    """flash_decode.cu's bf16 arithmetic: each split's keys in tiles of
    DECODE_TK, each of the four warps with its 16-key slice of every tile
    and its own online softmax in base 2; the warps merged in the block,
    the splits by the combine kernel (m in natural-log units)."""
    B, H, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    G = H // KVH
    scale = np.float32(1.0 / D ** 0.5)
    neg = float(NEG * LOG2E)
    out = torch.empty((B, H, D), dtype=torch.float32)
    for b in range(B):
        for j in range(KVH):
            qf = q[b, j * G:(j + 1) * G].float()
            kf, vf = k[b, j].float(), v[b, j].float()
            parts = []
            for s0, s1 in t_fd.split_bounds(S, nsplit):
                warps = []
                for w in range(DECODE_WARPS):
                    m = torch.full((G, 1), neg)
                    l = torch.zeros((G, 1))
                    acc = torch.zeros((G, D))
                    for k0 in range(s0, s1, DECODE_TK):
                        a, e = k0 + 16 * w, min(s1, k0 + 16 * w + 16)
                        if a >= e:
                            continue
                        x = (((qf @ kf[a:e].T) * scale + bias[b, a:e])
                             * float(LOG2E))
                        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
                        alpha = torch.exp2(m - m_new)
                        p = torch.exp2(x - m_new)
                        l = l * alpha + p.sum(-1, keepdim=True)
                        acc = acc * alpha + _pv(p, vf[a:e], True)
                        m = m_new
                    warps.append((m, l, acc))
                mx = torch.stack([w_[0] for w_ in warps]).amax(0)
                f = [torch.exp2(w_[0] - mx) for w_ in warps]
                parts.append((mx * float(LN2),
                              sum(fi * w_[1] for fi, w_ in zip(f, warps)),
                              sum(fi * w_[2] for fi, w_ in zip(f, warps))))
            mx = torch.stack([p_[0] for p_ in parts]).amax(0)
            e = [torch.exp(p_[0] - mx) for p_ in parts]
            num = sum(ei * p_[2] for ei, p_ in zip(e, parts))
            den = sum(ei * p_[1] for ei, p_ in zip(e, parts))
            out[b, j * G:(j + 1) * G] = num / torch.clamp(den, min=1e-30)
    return out.to(q.dtype)


def _inputs(shapes, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.normal(size=s).astype(np.float32) for s in shapes]
    return ([torch.from_numpy(a).to(torch.bfloat16) for a in arrays],
            [jnp.asarray(a, jnp.bfloat16) for a in arrays])


# --- (a) the numerics --------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("D", [64, 128, 256])
def test_prefill_tc_numerics(D, S, causal):
    H, KV = WIDTHS[D]
    (q, k, v), (rq, rk, rv) = _inputs(
        [(1, H, S, D), (1, KV, S, D), (1, KV, S, D)], 31 * S + D)
    got = prefill_tc_emulated(q, k, v, causal)
    _close(got, t_fp.flash_prefill_plain(q, k, v, causal))
    want = r_fp.flash_prefill(rq, rk, rv, causal=causal, block_q=S,
                              block_k=S, interpret=True)
    _close(got, np.asarray(want, np.float32))


def test_single_bf16_p_breaks_the_tolerance():
    """Why the kernels split P: rounded once to bf16, the first rows of a
    causal sequence (few keys each) miss BF16_TOL; split, they keep it."""
    (q, k, v), _ = _inputs([(1, 16, 128, 128), (1, 1, 128, 128),
                            (1, 1, 128, 128)], 5)
    want = t_fp.flash_prefill_plain(q, k, v, True)
    with pytest.raises(AssertionError):
        _close(prefill_tc_emulated(q, k, v, True, split=False), want)
    _close(prefill_tc_emulated(q, k, v, True), want)


@pytest.mark.parametrize("S", SEQS)
@pytest.mark.parametrize("G,D", [(1, 64), (4, 256), (16, 128)])
def test_decode_tc_numerics(G, D, S):
    B, KVH = 2, 2
    (q, k, v), (rq, rk, rv) = _inputs(
        [(B, G * KVH, D), (B, KVH, S, D), (B, KVH, S, D)], 17 * S + G)
    bias = np.zeros((B, S), np.float32)
    bias[1, :S // 3] = -1e30  # a padded row
    tb = torch.from_numpy(bias)
    got = decode_tc_emulated(q, k, v, tb, t_fd.decode_splits(B * KVH, S, 4))
    _close(got, t_fd.flash_decode_plain(q, k, v, tb))
    want = r_fd.flash_decode(rq, rk, rv, jnp.asarray(bias), block_s=S,
                             interpret=True)
    _close(got, np.asarray(want, np.float32))


def test_decode_tc_row_masked_everywhere_averages_v():
    """A bias row of -1e30 at every key: as in the reference, the softmax
    is uniform and the output is V's mean, not NaN, across several splits
    and warp slices."""
    B, H, KVH, S, D = 2, 16, 1, 1000, 128
    (q, k, v), (rq, rk, rv) = _inputs(
        [(B, H, D), (B, KVH, S, D), (B, KVH, S, D)], 3)
    bias = np.zeros((B, S), np.float32)
    bias[0] = -1e30
    tb = torch.from_numpy(bias)
    nsplit = t_fd.decode_splits(B * KVH, S, 132)
    assert nsplit > 1
    got = decode_tc_emulated(q, k, v, tb, nsplit)
    mean = v[0, 0].float().mean(0).expand(H, D)
    _close(got[0], mean)
    _close(got, t_fd.flash_decode_plain(q, k, v, tb))
    _close(got, np.asarray(r_fd.flash_decode(rq, rk, rv, jnp.asarray(bias),
                                             block_s=S, interpret=True),
                           np.float32))


# --- (b) the decode split choice ----------------------------------------------

@pytest.mark.parametrize("rows,S,sms", [
    (128, 32768, 132),  # llama3-405b decode_32k, B 16
    (8, 32768, 132),    # gemma3-1b, B 8
    (4, 4096, 132),
    (1, 1000, 132),
    (2, 511, 132),
    (1, 1, 132),
    (6, 70000, 8),
    (1000, 300, 132),
])
def test_decode_splits(rows, S, sms):
    n = t_fd.decode_splits(rows, S, sms)
    bounds = t_fd.split_bounds(S, n)
    assert bounds[0][0] == 0 and bounds[-1][1] == S
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    lengths = [e - s for s, e in bounds]
    assert min(lengths) >= 1
    if S >= t_fd.MIN_SPLIT:
        assert min(lengths) >= t_fd.MIN_SPLIT
    if rows * (S // t_fd.MIN_SPLIT) >= 2 * sms:
        assert rows * n >= 2 * sms
    assert max(lengths) <= t_fd.MAX_SPLIT


# --- (c) dispatch ---------------------------------------------------------------

class _FakeLibrary:
    def __init__(self, name, calls, rc):
        self.name, self.calls, self.rc = name, calls, rc

    def __getattr__(self, symbol):
        calls, name, rc = self.calls, self.name, self.rc

        def entry(*args):
            calls.append((name, symbol))
            return rc
        return entry


def _fake_card(monkeypatch, calls, rc=0, refuse=()):
    def library(name):
        if name in refuse:
            calls.append((name, "build"))
            raise RuntimeError(f"nvcc failed for {name}")
        return _FakeLibrary(name, calls, rc)
    monkeypatch.setattr(build, "library", library)
    # entries are looked up once and cached: start from none
    monkeypatch.setattr(build, "_ENTRIES", {})
    monkeypatch.setattr(build, "current_stream", lambda d: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))


def _prefill_args(dtype):
    q = torch.zeros((1, 4, 50, 64), dtype=dtype)
    return q, q[:, :2].clone(), q[:, :2].clone(), True


def _decode_args(dtype):
    q = torch.zeros((1, 4, 64), dtype=dtype)
    k = torch.zeros((1, 2, 50, 64), dtype=dtype)
    return q, k, k.clone(), torch.zeros((1, 50)), 2


LAUNCHERS = {"prefill": (t_fp._launch, _prefill_args, {
                 torch.bfloat16: ("flash_prefill_tc", "flash_prefill_tc_launch"),
                 torch.float32: ("flash_prefill", "flash_prefill_launch")}),
             "decode": (t_fd._launch, _decode_args, {
                 torch.bfloat16: ("flash_decode", "flash_decode_tc_launch"),
                 torch.float32: ("flash_decode", "flash_decode_launch")})}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["prefill", "decode"])
def test_each_dtype_asks_for_its_own_entry(monkeypatch, kernel, dtype):
    launch, args, entries = LAUNCHERS[kernel]
    calls = []
    _fake_card(monkeypatch, calls)
    out = launch(*args(dtype))
    assert out.dtype == dtype
    assert calls == [entries[dtype]]


@pytest.mark.parametrize("failure", ["build", "launch"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kernel", ["prefill", "decode"])
def test_no_fallback_between_dtypes(monkeypatch, kernel, dtype, failure):
    """A refused build or a launch error raises; the other dtype's kernel
    is never asked for."""
    launch, args, entries = LAUNCHERS[kernel]
    lib, entry = entries[dtype]
    calls = []
    if failure == "build":
        _fake_card(monkeypatch, calls, refuse=(lib,))
        with pytest.raises(RuntimeError, match="nvcc failed"):
            launch(*args(dtype))
        assert calls == [(lib, "build")]
    else:
        _fake_card(monkeypatch, calls, rc=700)
        with pytest.raises(RuntimeError, match=f"{entry}: CUDA error 700"):
            launch(*args(dtype))
        assert calls == [(lib, entry)]


def test_new_source_is_built():
    assert "flash_prefill_tc" in build.SOURCES
    assert (build.CSRC / "flash_prefill_tc.cu").exists()
