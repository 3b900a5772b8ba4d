"""The decode kernel's checked build (``flash_decode.out_of_bounds``) wired
to its library with a fake card, and mirrored against its source.

  * ``out_of_bounds`` sets q, k, v, the bias, the output and the partials
    (acc, m and l apart, each of exactly the launch's size) as the byte
    ranges, launches the checked build's entry with the splits and the
    tile ``flash_decode`` takes (counting no launch), and names a
    recorded access by its nearest operand; it refuses CPU tensors;
  * the build is ``csrc/flash_decode.cu`` under FDT_CHECK_BOUNDS: its
    record count is the wrapper's, it holds every operand's range, and its
    checked copies, loads and stores are defined before the first kernel.
"""
import contextlib
import re
import types

import pytest
import torch

from repro_torch.kernels import build, flash_decode


class _FakeCard:
    """A CPU tensor that claims a CUDA device (the wrapper's checks)."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape = t.dtype, t.shape

    def dim(self):
        return self.t.dim()

    def contiguous(self):
        return self

    def data_ptr(self):
        return self.t.data_ptr()

    def numel(self):
        return self.t.numel()

    def element_size(self):
        return self.t.element_size()


@pytest.fixture
def fake_card(monkeypatch):
    """The checked build's three entries as fakes on a card of 132 SMs;
    yields (the ranges set, the launches)."""
    spans, calls = [], []

    def check_set(lo, hi, n):
        spans[:] = [(lo[i], hi[i]) for i in range(n)]
        return 0

    def check_get(count, rec):
        v_end = spans[2][1]
        count._obj.value = 1
        rec[0], rec[1], rec[2] = v_end + 32, 16, 440
        return 0

    def launch(*args):
        calls.append(args)
        return 0

    lib = "flash_decode_checked"
    entries = {(lib, "flash_decode_check_set"): check_set,
               (lib, "flash_decode_tc_launch"): launch,
               (lib, "flash_decode_launch"): launch,
               (lib, "flash_decode_check_get"): check_get}
    monkeypatch.setattr(build, "entry",
                        lambda l, name, argtypes: entries[(l, name)])
    real_empty, real_zeros = torch.empty, torch.zeros
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: real_empty(
        *a, **{**kw, "device": "cpu"}))
    monkeypatch.setattr(torch, "zeros", lambda *a, **kw: real_zeros(
        *a, **{**kw, "device": "cpu"}))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=0,
                                              synchronize=lambda: None))
    monkeypatch.setattr(flash_decode, "_sms", lambda device: 132)
    yield spans, calls


@pytest.mark.parametrize("dtype,D,block_s,tk", [
    (torch.bfloat16, 64, None, 64), (torch.bfloat16, 128, 256, 128),
    (torch.float32, 64, None, None)])
def test_out_of_bounds_runs_the_checked_build(fake_card, dtype, D, block_s,
                                              tk):
    spans, calls = fake_card
    B, H, KV, S = 2, 9, 3, 100
    q = torch.zeros((B, H, D), dtype=dtype)
    k = torch.zeros((B, KV, S, D), dtype=dtype)
    bias = torch.zeros((B, S), dtype=torch.float32)
    before = flash_decode.flash_decode.launches
    out = flash_decode.out_of_bounds(_FakeCard(q), _FakeCard(k),
                                     _FakeCard(k.clone()), _FakeCard(bias),
                                     block_s)
    nsplit = (flash_decode.decode_splits(B * KV, S, 132)
              if dtype == torch.bfloat16 else
              flash_decode.decode_splits_f32(B * KV, S, 132, H // KV))
    f32 = dtype == torch.float32
    ptrs = 9 if f32 else 8
    assert len(calls) == 1
    assert calls[0][ptrs:ptrs + 6] == (B, H, KV, S, D, nsplit)
    assert calls[0][ptrs + 7:] == ((0,) if f32 else (0, tk))
    ml = B * H * nsplit
    size = q.element_size()
    want = [q.numel() * size, k.numel() * size, k.numel() * size,
            bias.numel() * 4, q.numel() * size, 4 * ml * D, 4 * ml, 4 * ml]
    if f32:
        want.append(4 * B * KV)  # the counters
    assert [hi - lo for lo, hi in spans] == want
    assert out["count"] == 1 and out["out"].shape == q.shape
    (line, name, offset, nbytes, access), = out["loads"]
    assert (line, name, offset - nbytes, access) == (440, "v", 32, 16)
    assert flash_decode.flash_decode.launches == before


def test_out_of_bounds_refuses_the_cpu():
    q = torch.zeros((1, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 1, 10, 64), dtype=torch.bfloat16)
    bias = torch.zeros((1, 10), dtype=torch.float32)
    with pytest.raises(ValueError, match="on the card"):
        flash_decode.out_of_bounds(q, k, k, bias)


def test_checked_build_mirrors_the_source():
    assert build.VARIANTS["flash_decode_checked"] == (
        "flash_decode", ("-DFDT_CHECK_BOUNDS",))
    src = (build.CSRC / "flash_decode.cu").read_text()
    assert "#ifdef FDT_CHECK_BOUNDS" in src
    records = re.search(r"#define FDT_CHECK_RECORDS (\d+)", src)
    assert records and int(records.group(1)) == flash_decode.CHECK_RECORDS
    ranges = re.search(r"#define FDT_CHECK_RANGES (\d+)", src)
    assert ranges and int(ranges.group(1)) >= 9  # the float32 launch's
    # the checked copies, loads and stores replace every use in the kernels
    first = src.index("__global__")
    for name in ("cp_async16(d, s, n)", "cp_async4(d, s, n)", "__ldcg(p)",
                 "FDT_LD(p)", "FDT_ST(p)"):
        assert src.index(f"#define {name}") < first, name
    kernels = src[first:]
    assert kernels.count("FDT_ST(") >= 8 and kernels.count("FDT_LD(") == 4
