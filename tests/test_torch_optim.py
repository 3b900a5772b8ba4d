"""The port's optimizer and schedule (``repro_torch.optim``) against the
reference's (``repro.optim``) on the CPU, on the same numpy inputs:

  * ``warmup_cosine`` over steps 0-200, float32 within 1 ulp (the cosine
    is XLA's against a float64 one rounded once: each is off the correctly
    rounded value now and then, and where ``1 + cos`` cancels, at other
    totals and later steps, an ulp of the cosine can be 2 of the result);
  * ``clip_by_global_norm``: the norm and the scaled gradients within 1
    ulp, clipped and not;
  * ``adamw_update`` on the same parameters and gradients, float32 and
    bf16 moments, factored and not, clipped and not, three steps in a row:
    new parameters, the moments, ``grad_norm`` and ``lr`` within 1 ulp of
    their dtype, on gradients whose float32 sums are exact in any order
    (multiples of 2^-6: the global norm and the factored means; clipped
    factored moments average gradients scaled by the clip, so they take
    the next bound); on random gradients, whose sums XLA and torch take in
    different orders, the parameters within 2 ulps and the moments within
    2^-20 of each leaf's largest value;
  * in place: the parameters and moments the caller holds take the new
    values.

The reference runs eagerly (operation by operation), so both sides round
each elementwise operation once; 1 ulp leaves room for library functions
(``cos``, ``pow``, ``sqrt``).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.optim import AdamWConfig as RConfig
from repro.optim import adamw_init as r_init
from repro.optim import adamw_update as r_update
from repro.optim import clip_by_global_norm as r_clip
from repro.optim import warmup_cosine as r_warmup_cosine
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, warmup_cosine)

SHAPES = {"a_vec": (7,), "b_mat": (6, 5), "c_cube": (2, 3, 4),
          "d_wide": (3, 33)}


def ulps(a, b) -> int:
    """Largest distance in units in the last place between two float32 (or
    bf16, widened exactly) arrays."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    return int(np.max(np.abs(ordered(a) - ordered(b)), initial=0))


def bf16_ulps(a, b) -> int:
    """The distance in bf16 ulps of two bf16 arrays widened to float32."""
    return ulps(a, b) >> 16


def as_np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


def inputs(seed: int, scale: float = 1.0, dyadic: bool = False):
    """Parameters and gradients from a seed; ``dyadic`` gradients are
    multiples of 2^-6 in [-1/8, 1/8], whose squares sum exactly in
    float32."""
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    if dyadic:
        grads = {k: (np.float32(2.0 ** -6) * rng.integers(-8, 9, s)
                     ).astype(np.float32) for k, s in SHAPES.items()}
    else:
        grads = {k: (scale * rng.standard_normal(s)).astype(np.float32)
                 for k, s in SHAPES.items()}
    return params, grads


def port(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("warmup,total", [(20, 100000), (5, 150), (0, 40)])
def test_warmup_cosine_matches_reference(warmup, total):
    steps = np.arange(0, 201)
    want = np.asarray(r_warmup_cosine(jnp.asarray(steps), warmup=warmup,
                                      total=total))
    got = np.array([float(warmup_cosine(int(s), warmup=warmup, total=total))
                    for s in steps], np.float32)
    assert got.dtype == want.dtype == np.float32
    assert ulps(got, want) <= 1
    t = warmup_cosine(torch.tensor(7), warmup=warmup, total=total)
    assert t.dtype == torch.float32 and t.ndim == 0


@pytest.mark.parametrize("max_norm", [0.5, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm):
    _, grads = inputs(1, scale=0.3)
    rg, rnorm = r_clip({k: jnp.asarray(v) for k, v in grads.items()},
                       max_norm)
    tg, tnorm = clip_by_global_norm(port(grads), max_norm)
    assert ulps(as_np(tnorm), as_np(rnorm)) <= 1
    assert (float(tnorm) > max_norm) == (max_norm == 0.5)
    for k in grads:
        assert tg[k].dtype == torch.float32
        assert ulps(as_np(tg[k]), as_np(rg[k])) <= 1, k


def assert_state_close(rstate, tstate, mdt, exact_sums: bool):
    """The moments within 1 ulp of their dtype (``exact_sums``), else within
    2^-20 of each leaf's largest value."""
    assert int(rstate["step"]) == int(tstate["step"])

    def near(got, want, what):
        got, want = as_np(got), as_np(want)
        assert got.shape == want.shape, what
        if not exact_sums:
            atol = 2.0 ** -20 * float(np.max(np.abs(want)))
            np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                       err_msg=str(what))
        elif mdt == "bfloat16":
            assert bf16_ulps(got, want) <= 1, what
        else:
            assert ulps(got, want) <= 1, what

    for k in SHAPES:
        near(tstate["m"][k], rstate["m"][k], k)
        rv, tv = rstate["v"][k], tstate["v"][k]
        if isinstance(rv, dict):
            assert set(tv) == {"vr", "vc"}
            for part in ("vr", "vc"):
                near(tv[part], rv[part], (k, part))
        else:
            assert not isinstance(tv, dict)
            near(tv, rv, k)


@pytest.mark.parametrize("dyadic", [True, False])
@pytest.mark.parametrize("clipped", [False, True])
@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("mdt", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(mdt, factored, clipped, dyadic):
    exact_sums = dyadic and not (factored and clipped)
    kw = dict(lr=3e-3, moment_dtype=mdt, factored=factored,
              clip_norm=0.5 if clipped else 1e6)
    rcfg, tcfg = RConfig(**kw), AdamWConfig(**kw)
    params, _ = inputs(2)
    rparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = port(params)
    held = dict(tparams)  # the caller's tensors: updated in place
    rstate, tstate = r_init(rcfg, rparams), adamw_init(tcfg, tparams)
    assert_state_close(rstate, tstate, mdt, True)
    for step in range(3):  # one step, then three in a row
        _, grads = inputs(10 + step, scale=0.2, dyadic=dyadic)
        lr_scale = r_warmup_cosine(step + 3, warmup=5, total=50)
        rparams, rstate, rmet = r_update(
            rcfg, rparams, {k: jnp.asarray(v) for k, v in grads.items()},
            rstate, lr_scale)
        _, tstate, tmet = adamw_update(
            tcfg, tparams, port(grads), tstate,
            warmup_cosine(step + 3, warmup=5, total=50))
        for k in SHAPES:
            assert tparams[k] is held[k]
            assert ulps(as_np(tparams[k]), as_np(rparams[k])) <= (
                1 if exact_sums else 2), (step, k)
        assert_state_close(rstate, tstate, mdt, exact_sums)
        assert ulps(as_np(tmet["grad_norm"]), as_np(rmet["grad_norm"])) <= 1
        assert ulps(as_np(tmet["lr"]), as_np(rmet["lr"])) <= 1
        assert (float(tmet["grad_norm"]) > kw["clip_norm"]) == clipped


def test_adamw_decays_every_parameter():
    """Weight decay reaches a parameter whose gradient is zero (a norm that
    the loss does not reach): p -> p - lr * wd * p, as in the reference."""
    cfg = AdamWConfig(lr=0.1, weight_decay=0.5)
    p = {"scale": torch.full((4,), 2.0)}
    state = adamw_init(cfg, p)
    adamw_update(cfg, p, {"scale": torch.zeros(4)}, state)
    want = np.float32(2.0) - np.float32(0.1) * (np.float32(0.5)
                                                * np.float32(2.0))
    assert torch.equal(p["scale"], torch.full((4,), float(want)))
    assert state["m"]["scale"].dtype == torch.float32
    assert int(state["step"]) == 1


def test_bias_correction_is_a_float32_power():
    """``b ** t`` in float32 (the reference's ``t`` is a float32 array): at
    step 1, m/bc1 is exactly g, and the first update moves each entry by lr
    (plus decay) against its gradient's sign."""
    cfg = AdamWConfig(lr=0.01, weight_decay=0.0, eps=0.0)
    p = {"w": torch.zeros(5)}
    g = torch.tensor([1.0, -2.0, 0.5, -0.25, 3.0])
    state = adamw_init(cfg, p)
    adamw_update(cfg, p, {"w": g}, state)
    np.testing.assert_allclose(p["w"].numpy(), -0.01 * np.sign(g.numpy()),
                               rtol=1e-6)
    want = np.float32(1.0) - np.float32(0.9) ** np.float32(1.0)
    assert float(1.0 - torch.pow(0.9, torch.tensor(1.0))) == float(want)
