"""The attention kernel's training route on the CPU: ``FlashPrefill``'s
backward (``flash_prefill_backward``) against autograd of the plain
version, and the bf16 kernel's checked build (``out_of_bounds``) wired to
its library with a fake card.

  * dq, dk, dv against autograd through ``flash_prefill_plain`` in float64
    (the backward computes in float32: within 2e-6 of each gradient's
    largest value), causal and full, with GQA groups of 1, 2 and 3, ragged
    S, and query blocks that split S unevenly;
  * ``ops.prefill_attention`` always takes ``FlashPrefill``, which builds
    a graph only while autograd records and an operand requires a
    gradient; under ``torch.no_grad()`` its output is ``flash_prefill``'s,
    bit for bit (serving is unchanged);
  * ``out_of_bounds`` sets q, k, v and the output as the byte ranges,
    launches the checked build's entry (counting no launch), names a
    recorded access by its nearest operand and raises on the build's
    map-range error; the build's flag, record count and error code mirror
    the source, whose checked kernel is the production one plus a check of
    each output store.
"""
import contextlib
import re
import types

import pytest
import torch

from repro_torch.config import KernelPolicy
from repro_torch.kernels import build, flash_prefill, ops


def grads(fn, q, k, v, w):
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    (fn(q, k, v) * w).sum().backward()
    return q.grad, k.grad, v.grad


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,H,KV,S,D,block", [(2, 4, 2, 37, 16, 50),
                                              (1, 3, 1, 5, 8, 1 << 26),
                                              (2, 6, 6, 64, 16, 700),
                                              (1, 9, 3, 29, 64, 2000)])
def test_backward_equals_autograd_of_the_plain_version(monkeypatch, causal,
                                                       B, H, KV, S, D, block):
    monkeypatch.setattr(flash_prefill, "BWD_BLOCK_ELEMS", block)
    g = torch.Generator().manual_seed(B * 1000 + S)
    q = torch.randn(B, H, S, D, generator=g, dtype=torch.float64)
    k = torch.randn(B, KV, S, D, generator=g, dtype=torch.float64)
    v = torch.randn(B, KV, S, D, generator=g, dtype=torch.float64)
    w = torch.randn(B, H, S, D, generator=g, dtype=torch.float64)
    want = grads(lambda *a: flash_prefill.flash_prefill_plain(*a, causal),
                 q, k, v, w)
    got = grads(lambda *a: flash_prefill.FlashPrefill.apply(*a, causal),
                q, k, v, w)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 2e-6 * scale, name


def test_the_autograd_route_only_under_autograd(monkeypatch):
    applied = []
    apply = flash_prefill.FlashPrefill.apply
    monkeypatch.setattr(flash_prefill.FlashPrefill, "apply",
                        lambda *a: applied.append(1) or apply(*a))
    q = torch.randn(1, 4, 20, 16)
    k, v = torch.randn(1, 2, 20, 16), torch.randn(1, 2, 20, 16)
    with torch.no_grad():
        a = ops.prefill_attention(q, k, v)
    b = ops.prefill_attention(q, k, v)  # nothing requires a gradient
    assert applied == [1, 1] and a.grad_fn is None and b.grad_fn is None
    c = ops.prefill_attention(q.requires_grad_(True), k, v)
    assert applied == [1, 1, 1] and c.requires_grad
    assert type(c.grad_fn).__name__ == "FlashPrefillBackward"
    with torch.no_grad():
        d = ops.prefill_attention(q, k, v)
    assert d.grad_fn is None
    want = flash_prefill.flash_prefill(q.detach(), k, v)
    for got in (a, b, c.detach(), d):
        assert torch.equal(got, want)
    plain = ops.prefill_attention(q, k, v, policy=KernelPolicy(enabled=False))
    assert len(applied) == 4 and plain.requires_grad
    assert "FlashPrefill" not in type(plain.grad_fn).__name__


class _FakeCard:
    """A CPU tensor that claims a CUDA device (the wrapper's checks)."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape, self.ndim = t.dtype, t.shape, t.ndim

    def contiguous(self):
        return self

    def data_ptr(self):
        return self.t.data_ptr()

    def numel(self):
        return self.t.numel()

    def element_size(self):
        return self.t.element_size()


def test_out_of_bounds_runs_the_checked_build(monkeypatch):
    spans, calls = [], []

    def check_set(lo, hi, n):
        spans[:] = [(lo[i], hi[i]) for i in range(n)]
        return 0

    def launch(*args):
        calls.append(args)
        return 0

    def check_get(count, rec):
        k_end = spans[1][1]
        count._obj.value = 1
        rec[0], rec[1], rec[2] = k_end + 64, 16384, 321
        return 0

    lib = "flash_prefill_tc_checked"
    entries = {(lib, "flash_prefill_tc_check_set"): check_set,
               (lib, "flash_prefill_tc_launch"): launch,
               (lib, "flash_prefill_tc_check_get"): check_get}
    monkeypatch.setattr(build, "entry",
                        lambda l, name, argtypes: entries[(l, name)])
    real_empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: real_empty(
        *a, **{**kw, "device": "cpu"}))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=0,
                                              synchronize=lambda: None))
    q = torch.zeros((2, 9, 40, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 3, 40, 64), dtype=torch.bfloat16)
    before = flash_prefill.flash_prefill.launches
    out = flash_prefill.out_of_bounds(_FakeCard(q), _FakeCard(k),
                                      _FakeCard(k.clone()), causal=True)
    assert len(calls) == 1 and calls[0][4:10] == (2, 9, 3, 40, 64, 1)
    assert [hi - lo for lo, hi in spans] == [q.numel() * 2, k.numel() * 2,
                                             k.numel() * 2, q.numel() * 2]
    assert out["count"] == 1
    (line, name, offset, size, nbytes), = out["loads"]
    assert (line, name, offset - size, nbytes) == (321, "k", 64, 16384)
    assert flash_prefill.flash_prefill.launches == before
    with pytest.raises(ValueError, match="bf16"):
        flash_prefill.out_of_bounds(q, k, k)  # the CPU
    # the host's check of the tensor maps against the ranges set
    entries[(lib, "flash_prefill_tc_launch")] = (
        lambda *a: flash_prefill.MAP_RANGE_ERROR)
    with pytest.raises(RuntimeError, match="does not span"):
        flash_prefill.out_of_bounds(_FakeCard(q), _FakeCard(k),
                                    _FakeCard(k.clone()), causal=True)


def test_checked_build_mirrors_the_source():
    assert build.VARIANTS["flash_prefill_tc_checked"] == (
        "flash_prefill_tc", ("-DFPT_CHECK_BOUNDS",))
    src = (build.CSRC / "flash_prefill_tc.cu").read_text()
    assert "#ifdef FPT_CHECK_BOUNDS" in src
    records = re.search(r"#define FPT_CHECK_RECORDS (\d+)", src)
    assert records and int(records.group(1)) == flash_prefill.CHECK_RECORDS
    code = re.search(r"#define FPT_ERR_MAP_RANGE (\d+)", src)
    assert code and int(code.group(1)) == flash_prefill.MAP_RANGE_ERROR
    # the kernel's one output store goes through a check; its three TMA
    # loads (q, k, v) and its setmaxnreg are the production kernel's, and
    # the host holds the three maps against the ranges set
    start = src.index("flash_prefill_tc_kernel(")
    body = src[start:src.index("cuTensorMapEncodeTiled", start)]
    assert body.count("FPT_STORE_OK(") == 1 and "FPT_TMA" not in src
    assert body.count("tma_load_3d(") == 3
    assert "#ifndef FPT_CHECK_BOUNDS" not in src
    assert body.count("setmaxnreg_dec<") == 1
    assert body.count("setmaxnreg_inc<") == 1
    launch = src[src.index("static int fpt_launch("):]
    assert launch.count("fpt_map_ok(") == 3
