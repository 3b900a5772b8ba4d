"""The port's kernel-ops entry point (``repro_torch.kernels.ops``: on the
CPU, the kernels' plain versions) against the reference's
``repro.kernels.ops`` in Pallas interpret mode, on the same numpy inputs.

  * ``prefix_sum``: exact for int32 (wrapping as XLA's int32 cumsum wraps)
    and integer-valued float32, inclusive and exclusive; exact for int64
    (the ``torch.cumsum`` route). Random float32 within rtol 1e-5: the two
    sum in different orders. The plain version's order is also held
    against a scalar emulation of the CUDA kernel's passes.
  * ``geo_positions_fused``: steps equal except where the float64 quotient
    ``log(u) / log1p(-p)`` lies within 2 float32 ulp of an integer (torch's
    and XLA's CPU ``log`` may differ by 1 ulp, and ``floor`` turns that
    into a step of one more or less); positions are the running sum of the
    port's steps, minus 1.
  * ``decode_attention``: rtol = atol = 2e-5 in float32 (the reference's
    own test tolerance); in bf16 rtol 1e-2 with atol 1e-3, which holds one
    bf16 ulp of any value (at most 2^-7 of it) and is well below the
    outputs' size. With GQA, a ragged S and bias masks.
  * ``prefill_attention``: 2e-4, causal and full, at multiples of the
    blocks; at a ragged S the port equals the reference's dense oracle,
    where the reference's own wrapper does not when non-causal (it lets
    zero-padded keys into the softmax).

The CUDA legs run only on a card, where ``chip_smoke.py`` (phase D) holds
each kernel against its plain version.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as r_ops
from repro.kernels import ref as r_ref
from repro_torch.config import KernelPolicy
from repro_torch.kernels import flash_prefill as t_fp
from repro_torch.kernels import geo_gaps as t_geo
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import prefix_sum as t_ps
from repro_torch.kernels import threefry as t_threefry

OFF = KernelPolicy(enabled=False)
# bf16 outputs: one bf16 ulp (<= 2^-7 relative) plus a float32 margin.
BF16_TOL = (1e-2, 1e-3)


def both(a: np.ndarray, dtype=None):
    """The same numpy array as a jax and a torch array (bf16: both round
    the same float32 values to nearest even)."""
    if dtype == "bfloat16":
        return (jnp.asarray(a, jnp.bfloat16),
                torch.from_numpy(a).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a)


def as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# --- prefix_sum ----------------------------------------------------------------

@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
@pytest.mark.parametrize("n", [1, 127, 128, 129, 8192, 10000])
def test_prefix_sum_exact(n, dtype, exclusive):
    x = np.random.default_rng(n).integers(0, 9, n).astype(dtype)
    rx, tx = both(x)
    want = np.asarray(r_ops.prefix_sum(rx, exclusive=exclusive,
                                       interpret=True))
    got = t_ops.prefix_sum(tx, exclusive=exclusive)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    np.testing.assert_array_equal(want, got.numpy())


def test_prefix_sum_int64_takes_cumsum(monkeypatch):
    monkeypatch.setattr(t_ops, "prefix_sum_tiles", _refuse)
    x = np.array([2**32, 2**32, 1, -7], np.int64)
    rx, tx = both(x)
    want = np.asarray(r_ops.prefix_sum(rx, interpret=True))
    np.testing.assert_array_equal(want, t_ops.prefix_sum(tx).numpy())
    np.testing.assert_array_equal(
        np.asarray(r_ops.prefix_sum(rx, exclusive=True, interpret=True)),
        t_ops.prefix_sum(tx, exclusive=True).numpy())


def test_prefix_sum_int32_wraps_as_the_reference():
    x = np.random.default_rng(1).integers(2**29, 2**30, 3000).astype(np.int32)
    rx, tx = both(x)
    want = np.asarray(r_ops.prefix_sum(rx, interpret=True))
    got = t_ops.prefix_sum(tx).numpy()
    assert (want < 0).any()  # the sum wrapped
    np.testing.assert_array_equal(want, got)


def test_prefix_sum_random_float32_within_rtol():
    x = np.random.default_rng(2).random(10000).astype(np.float32)
    rx, tx = both(x)
    want = np.asarray(r_ops.prefix_sum(rx, interpret=True))
    np.testing.assert_allclose(t_ops.prefix_sum(tx).numpy(), want, rtol=1e-5)


def _emulate_scan(x: np.ndarray, threads: int, items: int) -> np.ndarray:
    """csrc/scan.cu's three passes, scalar by scalar, in float32."""
    tile = threads * items

    def block(vals):
        vals = np.concatenate([vals, np.zeros((-len(vals)) % tile, np.float32)])
        xs = vals.reshape(threads, items)
        loc = np.empty_like(xs)
        for t in range(threads):
            acc = xs[t, 0]
            loc[t, 0] = acc
            for i in range(1, items):
                acc = np.float32(acc + xs[t, i])
                loc[t, i] = acc
        incl = loc[:, -1].copy()
        d = 1
        while d < threads:
            nxt = incl.copy()
            for t in range(d, threads):
                nxt[t] = np.float32(incl[t] + incl[t - d])
            incl, d = nxt, d * 2
        pre = loc.copy()
        for t in range(1, threads):
            pre[t] = (incl[t - 1] + loc[t]).astype(np.float32)
        return pre.reshape(-1), incl[-1]

    nt = max(1, -(-len(x) // tile))
    pres, tots = zip(*(block(x[t * tile:(t + 1) * tile]) for t in range(nt)))
    tots = np.array(tots, np.float32)
    carry, carries = np.float32(0), [np.float32(0)]
    for c in range(0, nt, tile):
        pre2, tot2 = block(tots[c:c + tile])
        carries.extend((carry + pre2).astype(np.float32))
        carry = np.float32(carry + tot2)
    out = np.concatenate([(carries[t] + pres[t]).astype(np.float32)
                          for t in range(nt)])
    return out[:len(x)]


@pytest.mark.parametrize("n", [1, 9, 64, 200, 777])
def test_prefix_sum_float32_order_is_the_kernels(monkeypatch, n):
    """At a tiny block (4 threads x 2 items) the plain version runs many
    tiles and several carry chunks: it must repeat the kernel's order bit
    for bit."""
    monkeypatch.setattr(t_ps, "THREADS", 4)
    monkeypatch.setattr(t_ps, "ITEMS", 2)
    monkeypatch.setattr(t_ps, "TILE", 8)
    x = np.random.default_rng(n).normal(size=n).astype(np.float32) * 1000
    got = t_ps.prefix_sum_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, _emulate_scan(x, 4, 2))


# --- geo_positions_fused --------------------------------------------------------

def _quotient_near_integer(u: np.ndarray, p: float) -> np.ndarray:
    pc = np.float64(np.clip(np.float32(p), np.float32(1e-12),
                            np.float32(1.0 - 1e-7)))
    quo = np.log(np.maximum(u, np.float32(1e-12)).astype(np.float64)) / np.log1p(-pc)
    ulp = np.spacing(quo.astype(np.float32)).astype(np.float64)
    return np.abs(quo - np.round(quo)) <= 2 * ulp


@pytest.mark.parametrize("p", [0.001, 0.1, 0.5, 0.9])
@pytest.mark.parametrize("n", [64, 1000, 9000])
def test_geo_positions_steps(n, p):
    u = np.random.default_rng(n).uniform(1e-6, 1 - 1e-6, n).astype(np.float32)
    ru, tu = both(u)
    want = np.asarray(r_ops.geo_positions_fused(ru, p, interpret=True))
    got = t_ops.geo_positions_fused(tu, p)
    assert got.dtype == torch.int32 and got.shape == (n,)
    steps = t_geo.geo_steps_plain(tu, p).numpy().astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), np.cumsum(steps) - 1)
    ref_steps = np.diff(want.astype(np.int64), prepend=-1)
    off = np.nonzero(ref_steps != steps)[0]
    assert np.abs(ref_steps[off] - steps[off]).max(initial=0) <= 1
    assert _quotient_near_integer(u[off], p).all(), off
    if off.size == 0:
        np.testing.assert_array_equal(want, got.numpy())


def test_geo_positions_ascend_and_take_any_shape():
    u = np.random.default_rng(0).uniform(1e-6, 1 - 1e-6, (3, 128))
    tu = torch.from_numpy(u.astype(np.float32))
    pos = t_geo.geo_gaps_tiles(tu, 0.05)
    assert pos.shape == (3, 128)
    flat = pos.reshape(-1).numpy()
    assert (np.diff(flat) > 0).all()
    np.testing.assert_array_equal(flat, t_ops.geo_positions_fused(
        tu.reshape(-1), 0.05).numpy())


# --- decode_attention -----------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KVH,S,D", [
    (1, 4, 4, 512, 64),
    (2, 8, 2, 1024, 64),    # GQA 4:1
    (2, 4, 1, 2048, 128),   # MQA
    (1, 2, 2, 640, 128),    # ragged S
])
def test_decode_attention(B, H, KVH, S, D, dtype):
    rng = np.random.default_rng(B * S + H)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, H, D), (B, KVH, S, D), (B, KVH, S, D)))
    (rq, tq), (rk, tk), (rv, tv) = (both(a, dtype) for a in (q, k, v))
    want = r_ops.decode_attention(rq, rk, rv, interpret=True)
    got = t_ops.decode_attention(tq, tk, tv)
    assert got.dtype == tq.dtype and got.shape == (B, H, D)
    rtol, atol = BF16_TOL if dtype == "bfloat16" else (2e-5, 2e-5)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("mask", ["padding", "window"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_bias_masks(mask, dtype):
    B, H, KVH, S, D = 3, 8, 2, 700, 64
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, H, D), (B, KVH, S, D), (B, KVH, S, D)))
    lens = rng.integers(S // 2, S + 1, (B, 1))
    pos = np.arange(S)[None, :]
    keep = pos < lens
    if mask == "window":
        keep &= pos >= lens - 128
    bias = np.where(keep, 0.0, -1e30).astype(np.float32)
    (rq, tq), (rk, tk), (rv, tv) = (both(a, dtype) for a in (q, k, v))
    rb, tb = both(bias)
    want = r_ops.decode_attention(rq, rk, rv, rb, interpret=True)
    got = t_ops.decode_attention(tq, tk, tv, tb)
    rtol, atol = BF16_TOL if dtype == "bfloat16" else (2e-5, 2e-5)
    np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=rtol, atol=atol)


# --- prefill_attention -----------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,KVH,S,D", [
    (1, 4, 4, 512, 64),
    (2, 8, 2, 512, 64),     # GQA 4:1
    (1, 4, 1, 1536, 128),   # MQA
])
def test_prefill_attention(B, H, KVH, S, D, causal):
    rng = np.random.default_rng(S + H)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, H, S, D), (B, KVH, S, D), (B, KVH, S, D)))
    (rq, tq), (rk, tk), (rv, tv) = (both(a) for a in (q, k, v))
    want = r_ops.prefill_attention(rq, rk, rv, causal=causal, block_q=128,
                                   block_k=256, interpret=True)
    # the port's keys tiles are its kernels' instances, 64 or 128 keys
    # (block_k 256 names none and raises)
    got = t_ops.prefill_attention(tq, tk, tv, causal=causal, block_q=128,
                                  block_k=128)
    assert got.shape == (B, H, S, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
def test_prefill_attention_ragged_s(causal):
    """S = 200 with 128-row blocks. The port equals the dense oracle both
    ways. The reference wrapper equals it causal; non-causal it lets the
    zero-padded keys into the softmax (ops.py:179-184) and differs by more
    than 1e-2: the recorded defect, pinned here."""
    B, H, KVH, S, D = 1, 4, 2, 200, 64
    rng = np.random.default_rng(200)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, H, S, D), (B, KVH, S, D), (B, KVH, S, D)))
    (rq, tq), (rk, tk), (rv, tv) = (both(a) for a in (q, k, v))
    oracle = np.asarray(r_ref.flash_prefill_ref(rq, rk, rv, causal=causal))
    wrapper = np.asarray(r_ops.prefill_attention(
        rq, rk, rv, causal=causal, block_q=128, block_k=128, interpret=True))
    got = t_ops.prefill_attention(tq, tk, tv, causal=causal, block_q=128,
                                  block_k=128).numpy()
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)
    if causal:
        np.testing.assert_allclose(got, wrapper, rtol=2e-4, atol=2e-4)
    else:
        assert np.abs(wrapper - oracle).max() > 1e-2


def test_causal_first_token_attends_itself_only():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 2, 256, 64))
                                .astype(np.float32)) for _ in range(3))
    got = t_ops.prefill_attention(q, k, v, causal=True)
    np.testing.assert_allclose(got[:, :, 0].numpy(), v[:, :, 0].numpy(),
                               rtol=1e-5, atol=1e-5)


# --- dispatch --------------------------------------------------------------------

def _refuse(*args, **kwargs):
    raise AssertionError("the kernel route was taken")


@pytest.mark.parametrize("wrapper", ["prefix_sum", "geo_positions_fused",
                                     "decode_attention", "prefill_attention"])
def test_disabled_policy_takes_the_plain_routes(monkeypatch, wrapper):
    x = torch.from_numpy(np.random.default_rng(4).integers(0, 9, 300)
                         .astype(np.int32))
    # (module, kernel wrapper, call); prefill reaches its wrapper through
    # ``FlashPrefill``'s forward, in the wrapper's own module
    calls = {
        "prefix_sum": (t_ops, "prefix_sum_tiles",
                       lambda **kw: t_ops.prefix_sum(x, **kw)),
        "geo_positions_fused": (t_ops, "geo_gaps_tiles",
                                lambda **kw: t_ops.geo_positions_fused(
                                    torch.rand(300), 0.2, **kw)),
        "decode_attention": (t_ops, "flash_decode",
                             lambda **kw: t_ops.decode_attention(
            torch.randn(1, 4, 64), torch.randn(1, 2, 100, 64),
            torch.randn(1, 2, 100, 64), **kw)),
        "prefill_attention": (t_fp, "flash_prefill",
                              lambda **kw: t_ops.prefill_attention(
                                  torch.randn(1, 4, 50, 64),
                                  torch.randn(1, 2, 50, 64),
                                  torch.randn(1, 2, 50, 64), **kw)),
    }
    module, kernel, call = calls[wrapper]
    torch.manual_seed(0)
    on = call()
    monkeypatch.setattr(module, kernel, _refuse)
    with pytest.raises(AssertionError, match="kernel route"):
        torch.manual_seed(0)
        call()
    torch.manual_seed(0)
    off = call(policy=OFF)
    if wrapper == "prefix_sum":
        np.testing.assert_array_equal(on.numpy(), off.numpy())
    else:
        np.testing.assert_allclose(as_f32(on), as_f32(off), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("name", ["block_s", "block_q", "block_k"])
def test_block_arguments_are_checked(name):
    q = torch.randn(1, 2, 16, 64)
    kw = {name: 0}
    with pytest.raises(ValueError, match=name):
        if name == "block_s":
            t_ops.decode_attention(q[:, :, 0], q, q, **kw)
        else:
            t_ops.prefill_attention(q, q, q, **kw)


def test_uniforms_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_threefry.uniforms(t_threefry.key(0), 16)
    got = t_threefry.uniforms(t_threefry.key(0), 16, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), t_threefry.uniforms_plain(t_threefry.key(0), 16).numpy())


@pytest.mark.parametrize("fn,args", [
    (t_ps.prefix_sum_tiles, (torch.zeros(4, dtype=torch.int32, device="meta"),)),
    (t_geo.geo_gaps_tiles, (torch.zeros(4, device="meta"), 0.1)),
])
def test_kernel_wrappers_refuse_other_devices(fn, args):
    with pytest.raises(ValueError, match="unsupported device"):
        fn(*args)
