"""The port's sharding rules (``repro_torch.models.layers``) against the
reference's, on the CPU. No compile: the reference's parameter shapes
come from ``jax.eval_shape`` of its ``init_model``, the port's from a model
built on ``meta``, and the meshes are stubs with the reference's
``axis_names`` and ``devices.shape`` (16 x 16, 2 x 16 x 16).

  * ``param_specs`` and ``sanitize_pspecs`` give every parameter the
    reference's spec, leaf for leaf (a stacked leaf's without its leading
    repeat axis): the ten reduced configs with ``set_moe_ep`` off and on,
    and whisper-small (vocabulary 51,865: the sanitizer drops its shards)
    and llama3-405b at full width;
  * ``NamedSharding.blocks`` tiles a tensor over a mesh of CPU entries,
    each entry holding one block; ``shard_batch*`` return their input and
    ``set_batch_axes`` records its axes.
"""
import types
from functools import partial

import numpy as np
import pytest
import torch

import jax

from repro import configs as rc
from repro.models import init_model as r_init_model
from repro.models import layers as r_layers
from repro_torch import configs as tc
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import convert, init_model, layers, param_specs
from repro_torch.models import shardings_for


def stub_mesh(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def ref_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from ref_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(autouse=True)
def _moe_ep_off():
    yield
    layers.set_moe_ep(False)
    r_layers.set_moe_ep(False)
    layers.set_batch_axes(())


def check_specs(rcfg, tcfg, ep: bool) -> int:
    """Every port parameter's spec (raw and sanitized on both meshes)
    against the reference's leaf; returns the leaves checked."""
    layers.set_moe_ep(ep)
    r_layers.set_moe_ep(ep)
    shapes = jax.eval_shape(partial(r_init_model, rcfg), jax.random.key(0))
    rspecs = r_layers.param_specs(shapes)
    rflat = {p: tuple(s) for p, s in ref_leaves(rspecs)}
    rshape = {p: s for p, s in ref_leaves(shapes)}
    model = init_model(tcfg, device="meta")
    tspecs = param_specs(model)
    tshapes = {n: p.shape for n, p in model.named_parameters()}
    P_len = len(tcfg.pattern)
    seen = set()
    for name, spec in tspecs.items():
        path, stacked = convert.reference_path(name, P_len)
        want = rflat[path]
        if stacked:
            assert want[0] is None, (name, want)
            want = want[1:]
        assert tuple(spec) == want, (name, spec, want)
        seen.add(path)
    assert seen == set(rflat), set(rflat) ^ seen
    for multi in (False, True):
        mesh = stub_mesh(multi)
        rsan = {p: tuple(s) for p, s in ref_leaves(
            r_layers.sanitize_pspecs(rspecs, shapes, mesh))}
        tsan = layers.sanitize_pspecs(tspecs, tshapes, mesh)
        for name, spec in tsan.items():
            path, stacked = convert.reference_path(name, P_len)
            want = rsan[path][1:] if stacked else rsan[path]
            assert tuple(spec) == want, (name, multi, spec, want)
            assert tuple(rshape[path].shape[int(stacked):]) == \
                tuple(tshapes[name])
    return len(seen)


@pytest.mark.parametrize("ep", [False, True])
@pytest.mark.parametrize("name", tc.ARCHS)
def test_param_specs_equal_the_references_reduced(name, ep):
    assert check_specs(rc.reduced(rc.get_config(name)),
                       tc.reduced(tc.get_config(name)), ep) > 0


@pytest.mark.parametrize("name", ["whisper_small", "llama3_405b"])
def test_param_specs_equal_the_references_full_width(name):
    rcfg, tcfg = rc.get_config(name), tc.get_config(name)
    check_specs(rcfg, tcfg, getattr(tcfg, "moe_ep", False))
    if name == "whisper_small":  # 51,865 rows do not split 16 ways
        model = init_model(tcfg, device="meta")
        specs = layers.sanitize_pspecs(param_specs(model), dict(
            model.named_parameters()), stub_mesh(False))
        assert tuple(param_specs(model)["embed"]) == ("model", "data")
        assert tuple(specs["embed"]) == (None, "data")


def test_spec_for_path_keeps_the_references_first_match():
    for path in ("/unembed", "/embed", "/blocks/p0/attn/wq",
                 "/blocks/p0/rwkv_t/time_decay_a", "/blocks/p0/rwkv_t/chan_k",
                 "/blocks/p0/moe/shared_gate", "/blocks/p0/mamba/in_proj"):
        for nd, stacked in ((2, False), (3, True)):
            assert tuple(layers.spec_for_path(path, nd, stacked)) == tuple(
                r_layers.spec_for_path(path, nd, stacked)), path
    # no rule names llama4-scout's shared expert: it stays replicated
    assert tuple(layers.spec_for_path("/blocks/p0/moe/shared_gate", 3,
                                      True)) == (None, None, None)


def test_named_sharding_blocks_tile_the_tensor():
    mesh = make_mesh((2, 2), ("data", "model"), devices="cpu")
    model = init_model(tc.reduced(tc.get_config("smollm_135m")),
                       device="cpu")
    shardings = shardings_for(model, mesh)
    for name, p in model.named_parameters():
        s = shardings[name]
        blocks = s.blocks(p.shape)
        covered = torch.zeros(p.shape, dtype=torch.int32)
        for bounds, devices in blocks.items():
            covered[tuple(slice(a, b) for a, b in bounds)] += len(devices)
        assert torch.all(covered == mesh.size // len(blocks)), name
        assert sum(len(d) for d in blocks.values()) == mesh.size
        shard = s.shard_shape(p.shape)
        assert all(tuple(b - a for a, b in bounds) == shard
                   for bounds in blocks)
    wq = shardings["blocks.0.attn.wq"]
    assert tuple(wq.spec) == ("data", "model") and len(
        wq.blocks(model.blocks[0].attn.wq.shape)) == 4


def test_activation_sharding_returns_its_input():
    x = torch.randn(4, 8, 2)
    layers.set_batch_axes(("data",))
    assert layers.get_batch_axes() == ("data",)
    assert layers.shard_batch(x) is x
    assert layers.shard_batch_seq(x) is x
    assert layers.shard_replicated_model(x) is x
    layers.set_batch_axes(())
    assert layers.get_batch_axes() == ()
