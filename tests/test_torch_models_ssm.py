"""The port's attention-free and encoder families against the reference's
on the CPU, at ``reduced()`` sizes in float32, with the reference's
parameters carried across (``params_from_reference``): rwkv6-7b
(RWKV6 time and channel mix), zamba2-1.2b (Mamba2 SSD blocks and the tied
shared attention block) and whisper-small (encoder and cross-attention).

  * ``forward`` logits within 2e-4 of the reference's, ``decode_step``
    logits and updated cache within 2e-4, ``prefill`` last logits and cache
    within 5e-3 (the port takes the SSM states from its full-sequence
    scans, the reference from S decode steps);
  * ``encode`` within 2e-4;
  * the mixers one by one: ``_causal_conv`` with and without a carried
    tail, ``_ssd_chunked`` over several chunks and a ragged last one,
    ``mamba_mixer`` over a sequence and one decode step from a state,
    ``_wkv6_scan``, ``rwkv_time_mix`` and ``rwkv_channel_mix`` with a
    carried cache, within 1e-5 (2e-4 where a scan accumulates);
  * zamba2's shared block is one module, the same at every position.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as rc
from repro.models import encode as r_encode
from repro.models import ssm as r_ssm
from repro.models import (decode_step as r_decode_step, forward as r_forward,
                          init_model as r_init_model, prefill as r_prefill)
from repro_torch import configs as tc
from repro_torch import models as tm
from repro_torch.models import layers as t_layers
from repro_torch.models import ssm as t_ssm

TOL = 2e-4
PREFILL_TOL = 5e-3
B, S, T = 2, 12, 16
SSM_ARCHS = ("rwkv6_7b", "zamba2_1p2b", "whisper_small")


@dataclasses.dataclass
class Setup:
    rcfg: object
    tcfg: object
    rparams: dict
    model: object
    tokens: np.ndarray
    memory: object


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


_SETUPS = {}


def setup_of(name: str) -> Setup:
    """One reference init an architecture for the whole file."""
    if name not in _SETUPS:
        rcfg = rc.reduced(rc.get_config(name))
        rparams = r_init_model(rcfg, jax.random.key(0))
        model = tm.params_from_reference(jax.tree.map(np.asarray, rparams),
                                         tc.reduced(tc.get_config(name)),
                                         "cpu")
        rng = np.random.default_rng(1)
        tokens = rng.integers(0, rcfg.vocab, (B, S)).astype(np.int32)
        memory = None
        if rcfg.n_memory_tokens:
            memory = rng.standard_normal(
                (B, rcfg.n_memory_tokens, rcfg.d_model)).astype(np.float32)
        _SETUPS[name] = Setup(rcfg, model.cfg, rparams, model, tokens, memory)
    return _SETUPS[name]


@pytest.fixture(scope="module", params=SSM_ARCHS)
def arch(request) -> Setup:
    return setup_of(request.param)


def _mem(s: Setup):
    if s.memory is None:
        return None, None
    return jnp.asarray(s.memory), torch.from_numpy(s.memory)


def test_forward_equals_the_reference(arch):
    s = arch
    jm, tmem = _mem(s)
    want, _ = r_forward(s.rparams, s.rcfg, jnp.asarray(s.tokens), jm)
    with torch.no_grad():
        got, _ = tm.forward(s.model, s.tokens, tmem)
    assert max_err(want, got.numpy()) <= TOL


def test_prefill_and_decode_step_equal_the_reference(arch):
    s = arch
    jm, tmem = _mem(s)
    rlog, rcache = r_prefill(s.rparams, s.rcfg, jnp.asarray(s.tokens), T, jm)
    with torch.no_grad():
        log, cache = tm.prefill(s.model, s.tokens, T, tmem)
    assert max_err(rlog, log.numpy()) <= PREFILL_TOL
    assert cache_err(rcache, cache, s.tcfg) <= PREFILL_TOL
    nxt = np.random.default_rng(7).integers(0, s.rcfg.vocab, (B, 1)).astype(
        np.int32)
    port_cache = tm.cache_from_reference(jax.tree.map(np.asarray, rcache),
                                         s.tcfg, "cpu")
    rlog2, rcache2 = r_decode_step(s.rparams, s.rcfg, rcache,
                                   jnp.asarray(nxt), S)
    with torch.no_grad():
        log2, cache2 = tm.decode_step(s.model, port_cache, nxt, S)
    assert max_err(rlog2, log2.numpy()) <= TOL
    assert cache_err(rcache2, cache2, s.tcfg) <= TOL


def test_encode_equals_the_reference():
    s = setup_of("whisper_small")
    frames = np.random.default_rng(2).standard_normal(
        (B, s.rcfg.n_memory_tokens, s.rcfg.enc_d_model)).astype(np.float32)
    want = r_encode(s.rparams, s.rcfg, jnp.asarray(frames))
    with torch.no_grad():
        got = tm.encode(s.model, torch.from_numpy(frames))
    assert max_err(want, got.numpy()) <= TOL


def test_shared_block_is_one_module():
    model = setup_of("zamba2_1p2b").model
    kinds = [bp.btype for bp in model.blocks]
    assert kinds.count("shared_attn") == model.cfg.repeats
    names = [n for n, _ in model.named_parameters()]
    assert sum(n.startswith("shared.") for n in names) == \
        len(list(model.shared.parameters()))
    assert not any(".attn." in n for n in names if n.startswith("blocks."))


# -- the mixers one by one -----------------------------------------------------------

def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("tail", [False, True], ids=["zeros", "carried"])
def test_causal_conv_equals_the_reference(tail):
    rng = np.random.default_rng(3)
    x, w = _rand(rng, 2, 7, 12), _rand(rng, 4, 12)
    st = _rand(rng, 2, 3, 12) if tail else None
    want, wtail = r_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                     None if st is None else jnp.asarray(st))
    got, gtail = t_ssm._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                    None if st is None else torch.from_numpy(st))
    assert max_err(want, got) <= 1e-5 and max_err(wtail, gtail) <= 1e-5


def test_ssd_chunked_equals_the_reference():
    """Chunks of 4 over 10 steps: three chunks, the last one padded."""
    rng = np.random.default_rng(4)
    xh, dt = _rand(rng, 2, 10, 3, 5), np.abs(_rand(rng, 2, 10, 3, scale=0.5))
    Bm, Cm = _rand(rng, 2, 10, 6), _rand(rng, 2, 10, 6)
    A = -np.abs(_rand(rng, 3)) - 0.1
    want, wstate = r_ssm._ssd_chunked(*(jnp.asarray(a) for a in
                                        (xh, dt, Bm, Cm, A)), 4)
    got, gstate = t_ssm._ssd_chunked(*(torch.from_numpy(a) for a in
                                       (xh, dt, Bm, Cm, A)), 4)
    assert max_err(want, got) <= TOL and max_err(wstate, gstate) <= TOL


def _block_params(s: Setup, name: str):
    """Layer 0's ``name`` parameters: the reference's dict, the port's
    module."""
    rp = {k: v[0] for k, v in jax.tree.map(
        np.asarray, s.rparams)["blocks"]["p0"][name].items()}
    return {k: jnp.asarray(v) for k, v in rp.items()}, \
        getattr(s.model.blocks[0], name)


def test_mamba_mixer_equals_the_reference():
    s = setup_of("zamba2_1p2b")
    rp, mod = _block_params(s, "mamba")
    rng = np.random.default_rng(5)
    x = _rand(rng, B, 9, s.rcfg.d_model)
    want, wcache = r_ssm.mamba_mixer(rp, jnp.asarray(x), s.rcfg)
    with torch.no_grad():
        got, gcache = t_ssm.mamba_mixer(mod, torch.from_numpy(x), s.tcfg)
    assert max_err(want, got) <= TOL
    for k in ("conv", "state"):
        assert max_err(wcache[k], gcache[k]) <= TOL
    # one decode step from that state
    x1 = _rand(rng, B, 1, s.rcfg.d_model)
    want1, wc1 = r_ssm.mamba_mixer(rp, jnp.asarray(x1), s.rcfg, wcache)
    with torch.no_grad():
        got1, gc1 = t_ssm.mamba_mixer(mod, torch.from_numpy(x1), s.tcfg,
                                      gcache)
    assert max_err(want1, got1) <= TOL
    for k in ("conv", "state"):
        assert max_err(wc1[k], gc1[k]) <= TOL


def test_wkv6_scan_equals_the_reference():
    rng = np.random.default_rng(6)
    r, k, v = (_rand(rng, 2, 6, 3, 4) for _ in range(3))
    w = 1 / (1 + np.exp(-_rand(rng, 2, 6, 3, 4)))
    u, st = _rand(rng, 3, 4), _rand(rng, 2, 3, 4, 4)
    want, wstate = r_ssm._wkv6_scan(*(jnp.asarray(a) for a in
                                      (r, k, v, w, u, st)))
    got, gstate = t_ssm._wkv6_scan(*(torch.from_numpy(a) for a in
                                     (r, k, v, w, u, st)))
    assert max_err(want, got) <= 1e-5 and max_err(wstate, gstate) <= 1e-5


def test_rwkv_mixes_equal_the_reference():
    s = setup_of("rwkv6_7b")
    rp, mod = _block_params(s, "rwkv_t")
    rng = np.random.default_rng(7)
    x = _rand(rng, B, 5, s.rcfg.d_model)
    cache = {k: np.asarray(v) for k, v in
             r_ssm.init_rwkv_cache(s.rcfg, B).items()}
    cache = {k: v + _rand(rng, *v.shape, scale=0.1) for k, v in cache.items()}
    jc = {k: jnp.asarray(v) for k, v in cache.items()}
    tcache = {k: torch.from_numpy(v) for k, v in cache.items()}
    for c_j, c_t in ((None, None), (jc, tcache)):
        want, wc = r_ssm.rwkv_time_mix(rp, jnp.asarray(x), s.rcfg, c_j)
        wy, wcc = r_ssm.rwkv_channel_mix(rp, jnp.asarray(x), s.rcfg, c_j)
        with torch.no_grad():
            got, gc = t_ssm.rwkv_time_mix(mod, torch.from_numpy(x), s.tcfg,
                                          c_t)
            gy, gcc = t_ssm.rwkv_channel_mix(mod, torch.from_numpy(x),
                                             s.tcfg, c_t)
        assert max_err(want, got) <= TOL and max_err(wy, gy) <= TOL
        for k in wc:
            assert max_err(wc[k], gc[k]) <= TOL
        assert max_err(wcc["shift_c"], gcc["shift_c"]) <= TOL


def test_initializer_scales_as_the_reference():
    """The port's init draws from its generator with the reference's
    scales: 1/sqrt(fan_in) for matrices, 0.02 for the embedding, zeros
    for norms, ones for Mamba's D."""
    cfg = tc.reduced(tc.get_config("zamba2_1p2b"))
    a = tm.init_model(cfg, 5, device="cpu")
    b = tm.init_model(cfg, 5, device="cpu")
    c = tm.init_model(cfg, 6, device="cpu")
    for (n, pa), (_, pb), (_, pc) in zip(a.named_parameters(),
                                         b.named_parameters(),
                                         c.named_parameters()):
        assert torch.equal(pa, pb), n
        if pa.numel() > 64 and pa.std() > 0:
            assert not torch.equal(pa, pc), n
    assert abs(float(a.embed.detach().std()) - 0.02) < 0.002
    w = a.blocks[0].mamba.in_proj.detach()
    assert abs(float(w.std()) * w.shape[0] ** 0.5 - 1) < 0.1
    assert float(a.blocks[0].mamba.D.detach().min()) == 1.0
    assert float(a.final_norm.scale.detach().abs().max()) == 0.0
    assert isinstance(t_layers.Initializer(None).normal((2, 3)),
                      torch.nn.Parameter)
