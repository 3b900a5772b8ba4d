"""The GPipe forward schedule (``repro_torch.parallel.pipeline``) on the
CPU:

  * ``pipeline_forward`` over a "stage" mesh of four CPU entries against
    the reference's ``reference_forward`` on ``tests/test_pipeline.py``'s
    stage function (``tanh(x @ w + b)``, D 16, 6 microbatches of 8), with
    its tolerance (rtol and atol 1e-5), and the port's own
    ``reference_forward`` bit for bit;
  * fewer microbatches than stages, and a single stage;
  * a reduced smollm's layers as stages (``transformer_stages``) against
    the port's forward pass (its hidden states before the final norm),
    within 1e-5; the attention runs ``(n_micro + n_stages - 1) x layers``
    times, warming and draining ticks included, as the schedule says.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.parallel.pipeline import reference_forward as r_reference_forward
from repro_torch import configs
from repro_torch.kernels import flash_prefill
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import init_model, transformer
from repro_torch.parallel import pipeline_forward, reference_forward
from repro_torch.parallel.pipeline import transformer_stages

D = 16
TOL = 1e-5


def stage_fn(p, x):  # shape-preserving block
    return torch.tanh(x @ p["w"] + p["b"])


def r_stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def stage_inputs(n_stages: int, n_micro: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n_stages, D, D)) * 0.5).astype(np.float32)
    b = (rng.standard_normal((n_stages, D)) * 0.1).astype(np.float32)
    batch = rng.standard_normal((n_micro, 8, D)).astype(np.float32)
    return w, b, batch


@pytest.mark.parametrize("n_stages,n_micro", [(4, 6), (4, 2), (1, 3)])
def test_pipeline_forward_matches_the_reference(n_stages, n_micro):
    w, b, batch = stage_inputs(n_stages, n_micro)
    mesh = make_mesh((n_stages,), ("stage",), devices="cpu")
    params = {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    got = pipeline_forward(stage_fn, params, torch.from_numpy(batch), mesh)
    want = r_reference_forward(r_stage_fn, {"w": jnp.asarray(w),
                                            "b": jnp.asarray(b)},
                               jnp.asarray(batch))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    own = reference_forward(stage_fn, params, torch.from_numpy(batch))
    assert torch.equal(got, own)


def test_pipeline_forward_checks_the_stage_count():
    w, b, batch = stage_inputs(3, 2)
    mesh = make_mesh((4,), ("stage",), devices="cpu")
    with pytest.raises(ValueError):
        pipeline_forward(stage_fn, {"w": torch.from_numpy(w),
                                    "b": torch.from_numpy(b)},
                         torch.from_numpy(batch), mesh)


def test_transformer_stages_match_the_forward_pass(monkeypatch):
    cfg = dataclasses.replace(configs.reduced(configs.get_config(
        "smollm_135m")), n_layers=4)
    model = init_model(cfg, 3, device="cpu")
    n_stages, n_micro, S = 2, 3, 12
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (n_micro, 1, S)))
    calls = []
    forward = flash_prefill.flash_prefill

    def counted(*a, **kw):
        calls.append(1)
        return forward(*a, **kw)

    monkeypatch.setattr(flash_prefill, "flash_prefill", counted)
    with torch.no_grad():
        want = torch.stack([transformer._stack(model, t, None)[0]
                            for t in tokens])
        calls.clear()
        h0 = torch.stack([model.embed[t] for t in tokens])
        fn, params = transformer_stages(model, n_stages)
        assert params["attn.wq"].shape[:2] == (n_stages, 2)
        mesh = make_mesh((n_stages,), ("stage",), devices="cpu")
        got = pipeline_forward(fn, params, h0, mesh)
    assert len(calls) == (n_micro + n_stages - 1) * cfg.n_layers
    assert float((got - want).abs().max()) <= TOL * float(want.abs().max())
    with torch.no_grad():
        own = reference_forward(fn, params, h0)
    assert torch.equal(got, own)
    with pytest.raises(ValueError):
        transformer_stages(model, 3)
