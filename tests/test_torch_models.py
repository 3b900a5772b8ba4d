"""The port's models (``repro_torch.models``) against the reference's
(``repro.models``) on the CPU, at ``reduced()`` sizes in float32, for the
seven attention architectures (the SSM and encoder families are in
``test_torch_models_ssm.py``). The reference's init cannot be reproduced
in torch, so each architecture's parameters come from the reference's
``init_model`` in this process, carried across by
``params_from_reference``; inputs are numpy arrays from a seed.

  * ``forward`` logits within 2e-4 (abs) of the reference's;
  * ``decode_step`` (from the reference's prefill cache, carried across by
    ``cache_from_reference``) logits and updated cache within 2e-4;
  * ``prefill`` (one forward pass in the port, S decode steps in the
    reference) last logits and cache within 5e-3, the reference's own bound
    for prefill against forward (``tests/test_model_equivalence.py``);
  * ``loss_fn`` (the layers, ``blockwise_attention`` and the MoE's
    routing are in ``test_torch_models_layers.py``);
  * ``attn_head_shard``: the reference reads query heads g-major in its
    forward pass and groups them ``h // G`` in decode, so its forward and
    prefill differ; the port holds each against its counterpart;
  * each attention case takes its route (the ops wrappers or the port's
    ``blockwise_attention``), and on the CPU no kernel launches.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as rc
from repro.models import (decode_step as r_decode_step, forward as r_forward,
                          init_model as r_init_model, loss_fn as r_loss_fn,
                          prefill as r_prefill)
from repro_torch import configs as tc
from repro_torch import models as tm
from repro_torch.kernels import flash_decode, flash_prefill
from repro_torch.kernels import ops as t_ops
from repro_torch.models import attention as t_attn

TOL = 2e-4          # forward and decode against the reference
PREFILL_TOL = 5e-3  # prefill (one pass) against the reference's decode steps
B, S, T = 2, 12, 16
ATTN_ARCHS = ("smollm_135m", "starcoder2_7b", "gemma3_1b", "llama3_405b",
              "llama32_vision_11b", "llama4_scout_17b_16e", "olmoe_1b_7b")


@dataclasses.dataclass
class Setup:
    rcfg: object
    tcfg: object
    rparams: dict
    model: object
    tokens: np.ndarray
    memory: object


def make_setup(rcfg, tcfg, seed: int = 1) -> Setup:
    rparams = r_init_model(rcfg, jax.random.key(0))
    model = tm.params_from_reference(jax.tree.map(np.asarray, rparams), tcfg,
                                     "cpu")
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32)
    memory = None
    if rcfg.n_memory_tokens:
        memory = rng.standard_normal(
            (B, rcfg.n_memory_tokens, rcfg.d_model)).astype(np.float32)
    return Setup(rcfg, tcfg, rparams, model, tokens, memory)


def jmem(s: Setup):
    return None if s.memory is None else jnp.asarray(s.memory)


def tmem(s: Setup):
    return None if s.memory is None else torch.from_numpy(s.memory)


def max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def cache_err(ref_cache, port_cache, cfg) -> float:
    ref = jax.tree.map(np.asarray, ref_cache)
    ours = tm.cache_to_reference(port_cache, cfg)
    assert ref.keys() == ours.keys()
    err = 0.0
    for k in ref:
        assert ref[k].keys() == ours[k].keys(), k
        for leaf in ref[k]:
            assert ref[k][leaf].shape == ours[k][leaf].shape, (k, leaf)
            err = max(err, max_err(ref[k][leaf], ours[k][leaf]))
    return err


def check_forward(s: Setup) -> None:
    want, raux = r_forward(s.rparams, s.rcfg, jnp.asarray(s.tokens), jmem(s))
    with torch.no_grad():
        got, aux = tm.forward(s.model, s.tokens, tmem(s))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert max_err(want, got.numpy()) <= TOL
    assert max_err(raux["moe_aux"], aux["moe_aux"].numpy()) <= TOL


def check_prefill_and_decode(s: Setup) -> None:
    rlog, rcache = r_prefill(s.rparams, s.rcfg, jnp.asarray(s.tokens), T,
                             jmem(s))
    with torch.no_grad():
        log, cache = tm.prefill(s.model, s.tokens, T, tmem(s))
    assert tuple(log.shape) == rlog.shape == (B, 1, s.rcfg.vocab)
    assert max_err(rlog, log.numpy()) <= PREFILL_TOL
    assert cache_err(rcache, cache, s.tcfg) <= PREFILL_TOL
    # one decode step from the reference's cache, on both sides
    nxt = np.random.default_rng(7).integers(0, s.rcfg.vocab, (B, 1)).astype(
        np.int32)
    port_cache = tm.cache_from_reference(jax.tree.map(np.asarray, rcache),
                                         s.tcfg, "cpu")
    rlog2, rcache2 = r_decode_step(s.rparams, s.rcfg, rcache,
                                   jnp.asarray(nxt), S)
    with torch.no_grad():
        log2, cache2 = tm.decode_step(s.model, port_cache, nxt, S)
    assert cache2 is port_cache  # updated in place
    assert log2.dtype == torch.float32
    assert max_err(rlog2, log2.numpy()) <= TOL
    assert cache_err(rcache2, cache2, s.tcfg) <= TOL


_SETUPS = {}


def setup_of(name: str) -> Setup:
    """One reference init an architecture for the whole file."""
    if name not in _SETUPS:
        _SETUPS[name] = make_setup(rc.reduced(rc.get_config(name)),
                                   tc.reduced(tc.get_config(name)))
    return _SETUPS[name]


@pytest.fixture(scope="module", params=ATTN_ARCHS)
def arch(request) -> Setup:
    return setup_of(request.param)


def test_forward_equals_the_reference(arch):
    check_forward(arch)


def test_prefill_and_decode_step_equal_the_reference(arch):
    check_prefill_and_decode(arch)


def test_no_kernel_launches_on_the_cpu(arch):
    before = (flash_prefill.flash_prefill.launches,
              flash_decode.flash_decode.launches)
    with torch.no_grad():
        tm.forward(arch.model, arch.tokens, tmem(arch))
        _, cache = tm.prefill(arch.model, arch.tokens, T, tmem(arch))
        tm.decode_step(arch.model, cache, arch.tokens[:, -1:], S)
    assert (flash_prefill.flash_prefill.launches,
            flash_decode.flash_decode.launches) == before


def test_routes_by_case(arch, monkeypatch):
    """Self-attention with no window takes ``ops.prefill_attention``, a
    window or cross-attention the port's ``blockwise_attention``, every
    decode ``ops.decode_attention``."""
    calls = {"prefill": 0, "blockwise": 0, "decode": 0}

    def counting(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(t_ops, "prefill_attention",
                        counting("prefill", t_ops.prefill_attention))
    monkeypatch.setattr(t_ops, "decode_attention",
                        counting("decode", t_ops.decode_attention))
    monkeypatch.setattr(t_attn, "blockwise_attention",
                        counting("blockwise", t_attn.blockwise_attention))
    cfg = arch.tcfg
    kinds = [bt for _ in range(cfg.repeats) for bt in cfg.pattern]
    local, cross = kinds.count("local"), kinds.count("cross")
    with torch.no_grad():
        _, cache = tm.prefill(arch.model, arch.tokens, T, tmem(arch))
    assert calls == {"prefill": len(kinds) - local, "decode": 0,
                     "blockwise": local + cross}
    with torch.no_grad():
        tm.decode_step(arch.model, cache, arch.tokens[:, -1:], S)
    assert calls["decode"] == len(kinds) + cross


# -- attn_head_shard ------------------------------------------------------------

def _head_shard_setup() -> Setup:
    """A reduced config with KV 2 and G 3 (no reduced() config has both
    above 1, so none would see the head order) and attn_head_shard on."""
    kw = dict(n_heads=6, n_kv_heads=2, attn_head_shard=True)
    return make_setup(
        dataclasses.replace(rc.reduced(rc.get_config("smollm_135m")), **kw),
        dataclasses.replace(tc.reduced(tc.get_config("smollm_135m")), **kw))


@pytest.fixture(scope="module")
def head_shard() -> Setup:
    return _head_shard_setup()


def test_head_shard_forward_equals_the_reference(head_shard):
    check_forward(head_shard)


def test_head_shard_prefill_and_decode_equal_the_reference(head_shard):
    check_prefill_and_decode(head_shard)


def test_reference_head_shard_forward_and_prefill_disagree(head_shard):
    """The reference's defect that the port keeps: under attn_head_shard its
    forward reads query heads g-major, its decode steps (and so its
    prefill) ``h // G``. Both sides show the same gap."""
    s = head_shard
    want_fwd, _ = r_forward(s.rparams, s.rcfg, jnp.asarray(s.tokens))
    want_pre, _ = r_prefill(s.rparams, s.rcfg, jnp.asarray(s.tokens), T)
    gap = max_err(np.asarray(want_fwd)[:, -1], np.asarray(want_pre)[:, 0])
    with torch.no_grad():
        fwd, _ = tm.forward(s.model, s.tokens)
        pre, _ = tm.prefill(s.model, s.tokens, T)
    assert gap > 10 * PREFILL_TOL
    assert abs(max_err(fwd[:, -1].numpy(), pre[:, 0].numpy()) - gap) <= TOL


def test_loss_fn_equals_the_reference(arch):
    s = arch
    rng = np.random.default_rng(4)
    batch = {"tokens": s.tokens,
             "targets": rng.integers(0, s.rcfg.vocab, (B, S)).astype(np.int32),
             "mask": (rng.random((B, S)) < 0.8).astype(np.float32)}
    if s.memory is not None:
        batch["memory"] = s.memory
    want, _ = r_loss_fn(s.rparams, s.rcfg,
                        {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, metrics = tm.loss_fn(s.model, {k: torch.from_numpy(v)
                                            for k, v in batch.items()})
    assert max_err(want, got) <= TOL and metrics["loss"] is got
