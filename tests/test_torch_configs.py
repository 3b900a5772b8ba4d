"""The port's architecture registry (``repro_torch.configs``) and its copy
of ``ModelConfig`` against the reference's, for all ten architectures:
every field, ``param_count`` and ``active_param_count``, ``reduced()``,
``shape_applicable`` and the shapes and dtypes of ``input_specs`` (meta
tensors in the port, ``ShapeDtypeStruct``s in the reference) are equal.
No model is run here.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import configs as rc
from repro.models import config as r_config
from repro_torch import configs as tc
from repro_torch.models import config as t_config

ARCHS = rc.ARCHS


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_registry_equals_the_reference():
    assert tc.ARCHS == rc.ARCHS
    assert tc.ALIASES == rc.ALIASES
    assert {k: dataclasses.asdict(v) for k, v in tc.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rc.SHAPES.items()}
    assert t_config.ATTN_BLOCKS == r_config.ATTN_BLOCKS


def test_model_config_fields_and_defaults_equal():
    ours = [(f.name, f.default) for f in dataclasses.fields(t_config.ModelConfig)]
    theirs = [(f.name, f.default)
              for f in dataclasses.fields(r_config.ModelConfig)]
    assert ours == theirs


@pytest.mark.parametrize("arch", ARCHS)
def test_config_fields_equal(arch):
    assert _fields(tc.get_config(arch)) == _fields(rc.get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal(arch):
    t, r = tc.get_config(arch), rc.get_config(arch)
    assert t.param_count() == r.param_count()
    assert t.active_param_count() == r.active_param_count()
    assert (t.repeats, t.hd, t.has_encoder, t.is_moe) == \
        (r.repeats, r.hd, r.has_encoder, r.is_moe)


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_equal(arch):
    t, r = tc.reduced(tc.get_config(arch)), rc.reduced(rc.get_config(arch))
    assert _fields(t) == _fields(r)
    assert t.param_count() == r.param_count()
    assert t.active_param_count() == r.active_param_count()


@pytest.mark.parametrize("alias", sorted(rc.ALIASES))
def test_aliases_resolve_to_the_same_config(alias):
    assert _fields(tc.get_config(alias)) == _fields(rc.get_config(alias))
    assert _fields(tc.get_config(alias)) == \
        _fields(tc.get_config(tc.ALIASES[alias]))


@pytest.mark.parametrize("shape", sorted(rc.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_shape_applicable_equal(arch, shape):
    assert tc.shape_applicable(tc.get_config(arch), shape) == \
        rc.shape_applicable(rc.get_config(arch), shape)


@pytest.mark.parametrize("shape", sorted(rc.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal(arch, shape):
    ours = tc.input_specs(tc.get_config(arch), shape)
    theirs = rc.input_specs(rc.get_config(arch), shape)
    assert list(ours) == list(theirs)
    for name, spec in theirs.items():
        t = ours[name]
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(spec.shape), name
        assert str(t.dtype).replace("torch.", "") == np.dtype(spec.dtype).name


def test_config_checks_its_pattern_as_the_reference_does():
    for mod in (t_config, r_config):
        with pytest.raises(AssertionError):
            mod.ModelConfig(name="x", vocab=8, d_model=8, n_layers=3,
                            n_heads=2, n_kv_heads=1, d_ff=8,
                            pattern=("dense", "dense"))
        with pytest.raises(AssertionError):
            mod.ModelConfig(name="x", vocab=8, d_model=8, n_layers=2,
                            n_heads=3, n_kv_heads=2, d_ff=8)


def test_models_and_configs_load_no_jax():
    """The model half imports torch and numpy only."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = ("import sys; import repro_torch.configs, repro_torch.models, "
            "repro_torch.launch.serve; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(src)))
    assert out.returncode == 0, out.stdout + out.stderr


def test_meta_specs_allocate_nothing():
    specs = tc.input_specs(tc.get_config("llama3_405b"), "train_4k")
    assert all(t.is_meta for t in specs.values())
    assert specs["tokens"].dtype == torch.int32
