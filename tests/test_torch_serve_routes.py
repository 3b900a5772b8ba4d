"""Each architecture's attention calls by route in one ``serve_batch``, on
the CPU at ``reduced()`` sizes (no reference needed).

A layer's calls by block type are the port's ``ATTENTION_CALLS``
(``models/transformer.py``, beside ``_apply_block`` and ``_decode_block``):
a prefill's causal and non-causal ``ops.prefill_attention`` (the
``flash_prefill`` kernel on the card) and ``blockwise_attention`` (plain
torch: a window or a memory), and a decode step's ``ops.decode_attention``
(``flash_decode``). The published configs' totals are ``chip_smoke.py``'s
``ARCH_ROUTES``, the table phase M asserts on the card, read from the
script itself; ``attention_calls`` sums to them, and a reduced
``serve_batch`` of every architecture calls each route exactly as its
layers' types say.
"""
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.models import attention
from repro_torch.models.transformer import attention_calls


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_routes", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # its dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


# phase M's table, and phase I's smollm-135m
ARCH_ROUTES = dict(_chip_smoke().ARCH_ROUTES, smollm_135m=(30, 0, 0, 30))


@pytest.mark.parametrize("arch", sorted(ARCH_ROUTES))
def test_published_configs_take_the_table(arch):
    cfg = configs.get_config(arch)
    assert attention_calls(cfg) == ARCH_ROUTES[arch]
    assert cfg.n_layers == cfg.repeats * len(cfg.pattern)


@pytest.mark.parametrize("arch", configs.ARCHS)
def test_serve_batch_calls_each_route_by_layer(monkeypatch, arch):
    calls = {"causal": 0, "full": 0, "blockwise": 0, "decode": 0}

    def counted(key, fn, by=None):
        def wrapped(*a, **kw):
            calls[by(kw) if by else key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(ops, "prefill_attention", counted(
        None, ops.prefill_attention,
        lambda kw: "causal" if kw.get("causal", True) else "full"))
    monkeypatch.setattr(ops, "decode_attention",
                        counted("decode", ops.decode_attention))
    monkeypatch.setattr(attention, "blockwise_attention",
                        counted("blockwise", attention.blockwise_attention))
    new = 3
    reqs = [serve.Request(prompt=[5, 6, 7, 8, 9], max_new=new),
            serve.Request(prompt=[3, 4], max_new=new)]
    done = serve.serve_batch(arch, reqs, seed=0, device="cpu")
    cfg = configs.reduced(configs.get_config(arch))
    want = attention_calls(cfg)
    assert (calls["causal"], calls["full"], calls["blockwise"]) == want[:3]
    assert calls["decode"] == want[3] * new
    assert all(len(r.out) == new for r in done)
    # every layer type of the published config is in the reduced one
    assert set(cfg.pattern) == set(configs.get_config(arch).pattern)
    assert torch.tensor([t for r in done for t in r.out]).lt(cfg.vocab).all()
