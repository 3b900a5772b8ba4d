"""The port's layers (``repro_torch.models.layers``), its
``blockwise_attention`` and its MoE FFN against the reference's on the
CPU, in float32, on the same numpy inputs (the MoE at olmoe-1b-7b's
reduced config with the reference's parameters carried across):

  * ``rms_norm``, ``rope``, ``gated_mlp`` (SwiGLU and the tanh GELU) and
    ``cross_entropy_loss`` within 1e-5;
  * ``blockwise_attention`` causal, full, windowed, g-major heads and over
    a memory of another length, within 1e-5;
  * the MoE's routing picks the reference's experts in its order (ties to
    the lower index), and ``moe_ffn`` and its aux loss equal the
    reference's within 2e-4, also where tokens drop past an expert's
    capacity.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as rc
from repro.models import attention as r_attn
from repro.models import init_model as r_init_model
from repro.models import layers as r_layers
from repro.models import moe as r_moe
from repro_torch import configs as tc
from repro_torch.models import attention as t_attn
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe

TOL = 2e-4


def max_err(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


# -- layers ------------------------------------------------------------------------

def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rms_norm_and_rope_equal_the_reference():
    rng = np.random.default_rng(0)
    x, scale = _rand(rng, 2, 5, 32), _rand(rng, 32)
    assert max_err(r_layers.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6),
                   t_layers.rms_norm(torch.from_numpy(x),
                                     torch.from_numpy(scale), 1e-6)) <= 1e-6
    q = _rand(rng, 2, 7, 3, 16)
    pos = np.arange(3, 10)
    for theta in (10_000.0, 1_000_000.0):
        want = r_layers.rope(jnp.asarray(q), jnp.asarray(pos)[None, :], theta)
        got = t_layers.rope(torch.from_numpy(q), torch.from_numpy(pos)[None, :],
                            theta)
        assert max_err(want, got) <= 1e-5


@pytest.mark.parametrize("gated", [True, False], ids=["swiglu", "gelu_tanh"])
def test_gated_mlp_equals_the_reference(gated):
    rng = np.random.default_rng(1)
    cfg_r = rc.reduced(rc.get_config("smollm_135m"))
    cfg_t = tc.reduced(tc.get_config("smollm_135m"))
    p = {"w_up": _rand(rng, 32, 64) / 32 ** 0.5,
         "w_down": _rand(rng, 64, 32) / 64 ** 0.5}
    if gated:
        p["w_gate"] = _rand(rng, 32, 64) / 32 ** 0.5
    mlp = t_layers.MLP(t_layers.Initializer(None), 32, 64, gated)
    with torch.no_grad():
        for k, v in p.items():
            getattr(mlp, k).copy_(torch.from_numpy(v))
    x = _rand(rng, 2, 5, 32)
    want = r_layers.gated_mlp({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), cfg_r)
    with torch.no_grad():
        got = t_layers.gated_mlp(mlp, torch.from_numpy(x), cfg_t)
    assert max_err(want, got) <= 1e-5


def test_cross_entropy_loss_equals_the_reference():
    rng = np.random.default_rng(2)
    logits = _rand(rng, 2, 6, 40) * 3
    targets = rng.integers(0, 40, (2, 6))
    mask = (rng.random((2, 6)) < 0.7).astype(np.float32)
    for m in (None, mask):
        want = r_layers.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(targets),
            None if m is None else jnp.asarray(m))
        got = t_layers.cross_entropy_loss(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if m is None else torch.from_numpy(m))
        assert max_err(want, got) <= 1e-5


@pytest.mark.parametrize("case", [
    dict(causal=True), dict(causal=False), dict(causal=True, window=5),
    dict(causal=True, head_shard=True), dict(causal=False, cross=True),
], ids=["causal", "full", "window", "head_shard", "cross"])
def test_blockwise_attention_equals_the_reference(case):
    rng = np.random.default_rng(3)
    case = dict(case)
    cross = case.pop("cross", False)
    Sq, Tk, H, KV, hd = 13, (9 if cross else 13), 6, 2, 16
    q, k, v = _rand(rng, 2, Sq, H, hd), _rand(rng, 2, Tk, KV, hd), \
        _rand(rng, 2, Tk, KV, hd)
    qp, kp = np.arange(Sq), np.arange(Tk)
    want = r_attn.blockwise_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qp),
        jnp.asarray(kp), chunk=4, **case)
    got = t_attn.blockwise_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(qp), torch.from_numpy(kp), chunk=4, **case)
    assert max_err(want, got) <= 1e-5


# -- MoE ------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def olmoe():
    rcfg = rc.reduced(rc.get_config("olmoe_1b_7b"))
    return rcfg, tc.reduced(tc.get_config("olmoe_1b_7b")), \
        jax.tree.map(np.asarray, r_init_model(rcfg, jax.random.key(0)))


def _moe_pair(olmoe, router=None):
    """The first layer's MoE parameters as the reference's dict and the
    port's module."""
    _, tcfg, rparams = olmoe
    rp = {k: v[0] for k, v in rparams["blocks"]["p0"]["moe"].items()}
    if router is not None:
        rp["router"] = router
    mod = t_moe.MoE(t_layers.Initializer(None), tcfg)
    with torch.no_grad():
        for k, v in rp.items():
            getattr(mod, k).copy_(torch.from_numpy(np.array(v)))
    return {k: jnp.asarray(v) for k, v in rp.items()}, mod


@pytest.mark.parametrize("router", ["init", "ties"])
def test_moe_picks_the_reference_experts(olmoe, router):
    """Top-K of the router's softmax: the same experts in the same order;
    with a zero router every probability ties and both take the lowest
    indices first."""
    rcfg, tcfg, _ = olmoe
    d, E = rcfg.d_model, rcfg.n_experts
    rp, mod = _moe_pair(olmoe, None if router == "init" else
                        np.zeros((d, E), np.float32))
    xt = _rand(np.random.default_rng(5), 64, d)
    probs = jax.nn.softmax(jnp.asarray(xt) @ rp["router"], axis=-1)
    _, want_idx = jax.lax.top_k(probs, rcfg.topk)
    _, idx, _ = t_moe.route(mod, torch.from_numpy(xt), tcfg)
    assert np.array_equal(np.asarray(want_idx), idx.numpy())
    if router == "ties":
        assert np.array_equal(idx.numpy(), np.tile(np.arange(rcfg.topk),
                                                   (64, 1)))


@pytest.mark.parametrize("tokens", [40, 600], ids=["within_capacity",
                                                   "drops"])
def test_moe_ffn_equals_the_reference(olmoe, tokens):
    """At 600 tokens every token's first choice is expert 0 (a large
    first feature and router weight), 600 > C = 256: the same tokens
    drop on both sides."""
    rcfg, tcfg, rparams = olmoe
    d = rcfg.d_model
    rng = np.random.default_rng(6)
    x = _rand(rng, 1, tokens, d)
    router = None
    if tokens == 600:
        x[..., 0] = 10.0
        router = np.array(rparams["blocks"]["p0"]["moe"]["router"][0])
        router[0, 0] = 5.0
    rp, mod = _moe_pair(olmoe, router)
    want, waux = jax.jit(r_moe.moe_ffn, static_argnums=2)(
        rp, jnp.asarray(x), rcfg)
    with torch.no_grad():
        got, aux = t_moe.moe_ffn(mod, torch.from_numpy(x), tcfg)
        _, idx, _ = t_moe.route(mod, torch.from_numpy(x[0]), tcfg)
    if tokens == 600:
        assert int((idx[:, 0] == 0).sum()) == tokens  # over capacity
    assert max_err(want, got) <= TOL and max_err(waux, aux) <= TOL
