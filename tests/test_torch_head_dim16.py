"""Head dim 16, the reduced configs', on the float32 attention kernels
(``csrc/flash_prefill.cu`` ``FpShape<16, 64>``, ``csrc/flash_decode.cu``
``fd_launch<16>``), which run only on the card; what the CPU can show:

  * the plain prefill and decode at D 16 against the reference's dense
    ``flash_prefill_ref`` / ``flash_decode_ref`` at a ragged S and the
    reduced configs' widths, and its Pallas kernels in interpret mode at
    one of them;
    the kernels' arithmetic emulated (``test_torch_attention_f32``'s
    emulations at the D 16 instance's shape: its two lanes a column, each
    on every other key, change only the order of the P . V sums) against
    the plain versions, at the float32 tolerances of ``chip_smoke.py``;
  * ``instance`` / ``prefill_config`` / ``decode_config`` choosing the D 16
    instances for every tuning candidate, and the launches passing D 16 and
    the keys tile to the C entries (a fake ``build.library``); a bf16 call
    at D 16 raises, naming the bf16 kernel's head dims;
  * ``serve --mode lm`` and ``train`` taking the reduced config on a
    ``cuda`` device (their parsers refuse it no longer);
  * ``chip_smoke.py``'s ``ARCH_ROUTES_N`` (phase N's launches a prefill
    and a step) is each reduced config's ``attention_calls``.
"""
import contextlib
import importlib.util
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import flash_decode as r_fd
from repro.kernels import flash_prefill as r_fp
from repro.kernels import ref as r_ref
from repro_torch import configs
from repro_torch.kernels import autotune as t_at
from repro_torch.kernels import build
from repro_torch.kernels import flash_decode as t_fd
from repro_torch.kernels import flash_prefill as t_fp
from repro_torch.launch import serve as t_serve
from repro_torch.launch import train as t_train
from repro_torch.models.transformer import attention_calls
from test_torch_attention_f32 import (DECODE_TOL, PREFILL_TOL, _bias, _close,
                                      _inputs, decode_f32_emulated,
                                      prefill_f32_emulated)

D = 16
F32, BF16 = torch.float32, torch.bfloat16
# (H, KV) of reduced configs: smollm-135m, llama3-405b (G 16), olmoe-1b-7b
WIDTHS = [(3, 1), (16, 1), (4, 4)]
# the ragged S also run through the reference (its dense version at every
# width, its Pallas kernel at the first): each is a compile
REF_S = 19


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 19, 64, 65, 130])
@pytest.mark.parametrize("H,KV", WIDTHS)
def test_prefill_d16_against_the_reference(H, KV, S, causal):
    (q, k, v), (rq, rk, rv) = _inputs(
        [(2, H, S, D), (2, KV, S, D), (2, KV, S, D)], 31 * S + H + causal)
    plain = t_fp.flash_prefill_plain(q, k, v, causal)
    got = prefill_f32_emulated(q, k, v, causal, t_fp.F32_INSTANCES[(D, 64)])
    _close(got, plain, PREFILL_TOL)
    if S == REF_S:
        _close(plain, np.asarray(r_ref.flash_prefill_ref(rq, rk, rv, causal),
                                 np.float32), PREFILL_TOL)
    if S == REF_S and (H, KV) == WIDTHS[0]:
        want = r_fp.flash_prefill(rq, rk, rv, causal=causal, block_q=S,
                                  block_k=S, interpret=True)
        _close(got, np.asarray(want, np.float32), PREFILL_TOL)


@pytest.mark.parametrize("S", [1, 28, 65, 300])
@pytest.mark.parametrize("H,KV", WIDTHS)
def test_decode_d16_against_the_reference(H, KV, S):
    B = 2
    (q, k, v), (rq, rk, rv) = _inputs(
        [(B, H, D), (B, KV, S, D), (B, KV, S, D)], 17 * S + H)
    bias = _bias(B, S, S)
    tb = torch.from_numpy(bias)
    plain = t_fd.flash_decode_plain(q, k, v, tb)
    nsplit = t_fd.decode_splits_f32(B * KV, S, 132, H // KV)
    _close(decode_f32_emulated(q, k, v, tb, nsplit), plain, DECODE_TOL)
    if S == 65:
        _close(plain, np.asarray(r_ref.flash_decode_ref(
            rq, rk, rv, jnp.asarray(bias)), np.float32), DECODE_TOL)
    if S == 65 and (H, KV) == WIDTHS[0]:
        want = r_fd.flash_decode(rq, rk, rv, jnp.asarray(bias), block_s=S,
                                 interpret=True)
        _close(plain, np.asarray(want, np.float32), DECODE_TOL)


def test_d16_instances_for_every_candidate():
    assert D in t_fp.HEAD_DIMS[F32] and D not in t_fp.HEAD_DIMS[BF16]
    assert D in t_fd.HEAD_DIMS[F32] and D not in t_fd.HEAD_DIMS[BF16]
    for cand in t_at.KERNELS["flash_prefill"].candidates:
        assert t_fp.instance(F32, D, *cand) == (t_fp.TILE_Q, 64)
        assert t_fp.prefill_config(F32, D, *cand) == {
            "block_q": 64, "block_k": 64, "stages": 2}
    for bs in t_at.KERNELS["flash_decode"].candidates:
        assert t_fd.instance(F32, D, bs) == t_fd.F32_TILE_KEYS[D] == 128
    # the table's default entry resolves them as any head dim
    q = t_at.tile_for("flash_prefill", 24, device="cpu")
    assert t_fp.instance(F32, D, *q) == (64, 64)
    assert t_fd.instance(F32, D, t_at.tile_for("flash_decode", 33,
                                               device="cpu")) == 128


class _Lib:
    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __getattr__(self, symbol):
        def entry(*args):
            self.calls.append((self.name, symbol, args))
            return 0
        return entry


@pytest.fixture
def fake_card(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "library", lambda name: _Lib(name, calls))
    monkeypatch.setattr(build, "_ENTRIES", {})
    monkeypatch.setattr(build, "current_stream", lambda d: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    return calls


def test_the_launches_pass_d16_and_the_tile(fake_card):
    q = torch.zeros((2, 16, 40, D))
    k = torch.zeros((2, 1, 40, D))
    t_fp._launch(q, k, k.clone(), True, t_fp.instance(F32, D))
    t_fd._launch(q[:, :, 0], k, k.clone(), torch.zeros((2, 40)), 2,
                 t_fd.instance(F32, D))
    (lib_p, entry_p, args_p), (lib_d, entry_d, args_d) = fake_card
    assert (lib_p, entry_p) == ("flash_prefill", "flash_prefill_launch")
    assert args_p[5:11] == (2, 16, 1, 40, D, 1) and args_p[-1] == 64
    assert (lib_d, entry_d) == ("flash_decode", "flash_decode_launch")
    assert args_d[9:15] == (2, 16, 1, 40, D, 2)


class _OnCard:
    """A CPU tensor that claims a CUDA device (the wrappers' checks)."""

    def __init__(self, t):
        self.t, self.device = t, torch.device("cuda", 0)
        self.dtype, self.shape, self.ndim = t.dtype, t.shape, t.ndim

    def dim(self):
        return self.ndim


@pytest.mark.parametrize("kernel", ["prefill", "decode"])
def test_bf16_at_d16_raises_naming_the_head_dims(fake_card, kernel):
    if kernel == "prefill":
        q = _OnCard(torch.zeros((1, 4, 8, D), dtype=BF16))
        k = _OnCard(torch.zeros((1, 1, 8, D), dtype=BF16))
        with pytest.raises(ValueError, match=r"bfloat16 kernel takes D in "
                                             r"\(64, 128, 256\)"):
            t_fp.flash_prefill(q, k, k)
    else:
        q = _OnCard(torch.zeros((1, 4, D), dtype=BF16))
        k = _OnCard(torch.zeros((1, 1, 8, D), dtype=BF16))
        bias = _OnCard(torch.zeros((1, 8)))
        with pytest.raises(ValueError, match=r"bfloat16 kernel takes D in "
                                             r"\(64, 128, 256\)"):
            t_fd.flash_decode(q, k, k, bias)
    assert fake_card == []  # nothing built or launched


def test_serve_lm_takes_the_reduced_config_on_the_card(monkeypatch):
    got = []
    monkeypatch.setattr(t_serve, "resolve_device",
                        lambda d: torch.device(d or "cuda"))
    monkeypatch.setattr(t_serve, "_lm_demo", lambda *a: got.append(a))
    assert t_serve.main(["--mode", "lm"]) == 0
    assert t_serve.main(["--mode", "lm", "--device", "cuda",
                         "--arch", "llama3_405b"]) == 0
    assert [(a[0], a[3], a[4].type) for a in got] == [
        ("smollm_135m", False, "cuda"), ("llama3_405b", False, "cuda")]


def test_serve_lm_prints_its_kernel_launches(monkeypatch, capsys):
    """``serve --mode lm`` ends with the attention kernels' launches by
    instance in its process (what the card's run holds against the reduced
    smollm's routes); on the CPU the plain versions run and none is
    counted."""
    import json

    def line():
        out = capsys.readouterr().out.splitlines()
        got = [ln for ln in out if ln.startswith("[serve] kernels ")]
        assert len(got) == 1, out
        return json.loads(got[0][len("[serve] kernels "):])

    t_serve._lm_demo("smollm_135m", 2, 3, False, torch.device("cpu"))
    ran = line()
    assert ran["decode_steps"] == 3
    for k in ("flash_prefill", "flash_decode"):
        assert ran[k] == {"launches": 0, "instances": {}}
    monkeypatch.setattr(t_fp.flash_prefill, "launches", 2)
    monkeypatch.setattr(t_fp.flash_prefill, "tiles",
                        {"float32 D16 (64, 64)": 2})
    t_serve._lm_demo("smollm_135m", 1, 2, False, torch.device("cpu"))
    ran = line()
    assert ran["decode_steps"] == 2 and ran["flash_prefill"] == {
        "launches": 2, "instances": {"float32 D16 (64, 64)": 2}}


def test_train_takes_the_reduced_config_on_the_card(monkeypatch):
    got = []
    monkeypatch.setattr(t_train, "train", lambda tc: got.append(tc) or {
        "losses": []})
    t_train.main(["--steps", "3"])
    t_train.main(["--device", "cuda", "--steps", "3"])
    assert [(tc.reduced, tc.device, tc.steps) for tc in got] == [
        (True, None, 3), (True, "cuda", 3)]


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_n", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


ARCH_ROUTES_N = _chip_smoke().ARCH_ROUTES_N


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_phase_n_routes_are_the_reduced_configs(arch):
    assert ARCH_ROUTES_N[arch] == attention_calls(
        configs.reduced(configs.get_config(arch)))
