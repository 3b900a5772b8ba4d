"""The dry run (``repro_torch.launch.dryrun``) on the CPU, on ``meta``:

  * a device's parameter bytes under the port's specs equal those under
    the reference's (``jax.eval_shape`` of its ``init_model``, its
    ``param_specs`` and ``sanitize_pspecs`` on stub meshes of 16 x 16 and
    2 x 16 x 16), for smollm-135m, olmoe-1b-7b (expert parallel) and
    llama3-405b at full width; llama3-405b's AdamW state (bf16 moments,
    factored) too, against the reference's ``adamw_init`` shapes and its
    dry run's ``vshard`` rule;
  * the ``meta`` build of llama3-405b allocates no storage;
  * one reduced train step's matrix-product FLOPs on ``meta`` equal
    ``3 x sum(2 M N K)`` of its forward products, from the config (the
    backward doubles each); the cut-and-scaled count (``step_flops``)
    equals the full count for every block type, MoE capacity,
    ``grad_accum``, ``remat``, an encoder and RWKV's sequence scaling;
  * ``run_cell`` writes its record, ``run_paper_cell`` runs the sharded
    sampler on the CPU at a small scale.
"""
import dataclasses
import json
import types
from functools import partial

import numpy as np
import pytest
import torch

import jax

from repro import configs as rc
from repro.models import init_model as r_init_model
from repro.models import layers as r_layers
from repro.optim import AdamWConfig as RAdamWConfig
from repro.optim import adamw_init as r_adamw_init
from repro_torch import configs as tc
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import init_model, layers


@pytest.fixture(autouse=True)
def _reset_rules():
    yield
    layers.set_moe_ep(False)
    r_layers.set_moe_ep(False)
    layers.set_batch_axes(())


def stub_mesh(multi_pod: bool):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return types.SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def ref_bytes(shapes, specs, mesh) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    total = 0
    for path, s in flat(shapes):
        spec = dict(flat(specs))[path] if isinstance(specs, dict) else specs
        dims = list(spec) + [None] * (len(s.shape) - len(spec))
        n = 1
        for size, d in zip(s.shape, dims):
            axes = () if d is None else ((d,) if isinstance(d, str) else d)
            n *= size // int(np.prod([sizes[a] for a in axes]))
        total += n * np.dtype(s.dtype).itemsize
    return total


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("name", ["smollm_135m", "olmoe_1b_7b",
                                  "llama3_405b"])
def test_parameter_bytes_equal_the_references(name, multi_pod):
    rcfg, tcfg = rc.get_config(name), tc.get_config(name)
    r_layers.set_moe_ep(rcfg.moe_ep)
    layers.set_moe_ep(tcfg.moe_ep)
    shapes = jax.eval_shape(partial(r_init_model, rcfg), jax.random.key(0))
    mesh = stub_mesh(multi_pod)
    pspecs = r_layers.sanitize_pspecs(r_layers.param_specs(shapes), shapes,
                                      mesh)
    model = init_model(tcfg, device="meta")
    got = dryrun.state_bytes(model, make_production_mesh(
        multi_pod=multi_pod), "train", {})
    assert got["params"] == ref_bytes(shapes, pspecs, mesh)
    if name != "llama3_405b":
        return
    # the AdamW state: bf16 moments, the factored second moment
    ocfg = RAdamWConfig(moment_dtype="bfloat16", factored=True)
    opt = jax.eval_shape(partial(r_adamw_init, ocfg), shapes)
    specs = dict(flat(pspecs))
    want = 4  # the step
    for path, m in flat(opt["m"]):
        want += ref_bytes({"x": m}, specs[path], mesh)
    for path, v in flat(opt["v"]):
        leaf, part = path[:-1], path[-1]
        if part in ("vr", "vc"):
            sp = list(specs[leaf]) + [None] * (
                len(dict(flat(shapes))[leaf].shape) - len(specs[leaf]))
            sp = sp[:-1] if part == "vr" else sp[:-2] + sp[-1:]
            want += ref_bytes({"x": v}, sp, mesh)
        else:
            want += ref_bytes({"x": v}, specs[path], mesh)
    assert got["opt"] == want


def test_the_meta_build_allocates_nothing():
    cfg = tc.get_config("llama3_405b")
    model = init_model(cfg, device="meta")
    params = list(model.parameters())
    assert all(p.is_meta for p in params)
    assert sum(p.numel() for p in params) > 4e11
    assert all(p.untyped_storage().nbytes() == 0 or p.is_meta
               for p in params)


def forward_products(cfg, B: int, S: int) -> int:
    """sum(2 M N K) of a dense model's forward pass: the projections, the
    plain attention's two products over all S x S pairs, the gated MLP and
    the unembedding."""
    d, hd, H, KV, ff = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, \
        cfg.d_ff
    tok = B * S
    layer = (2 * tok * d * (H + 2 * KV) * hd      # wq, wk, wv
             + 2 * tok * H * hd * d               # wo
             + 2 * (2 * B * H * S * S * hd)       # scores, probabilities x V
             + 3 * 2 * tok * d * ff)              # w_up, w_gate, w_down
    return cfg.n_layers * layer + 2 * tok * d * cfg.vocab


def test_a_train_steps_flops_equal_its_products():
    cfg = tc.reduced(tc.get_config("smollm_135m"))
    B, S = 2, 32
    assert cfg.remat == "none" and cfg.mlp_gated
    got = dryrun._counted(cfg, "train", B, S, S)
    assert got == 3 * forward_products(cfg, B, S)
    assert dryrun._counted(cfg, "prefill", B, S, S) == \
        forward_products(cfg, B, S)


SCALED = {
    "smollm_remat": ("smollm_135m", dict(remat="full", n_layers=3)),
    "gemma3": ("gemma3_1b", dict(n_layers=6)),
    "olmoe": ("olmoe_1b_7b", dict(n_layers=3)),
    "scout_accum": ("llama4_scout_17b_16e", dict(n_layers=3, grad_accum=2,
                                                 remat="segments")),
    "vision": ("llama32_vision_11b", dict(n_layers=6)),
    "whisper": ("whisper_small", dict(n_layers=3, enc_layers=3)),
    "rwkv": ("rwkv6_7b", dict(n_layers=3)),
    "zamba2": ("zamba2_1p2b", dict(n_layers=6)),
}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("case", sorted(SCALED))
def test_scaled_count_equals_the_full_count(case, kind):
    name, kw = SCALED[case]
    cfg = dataclasses.replace(tc.reduced(tc.get_config(name)), **kw)
    B, S = 8, 512 if cfg.is_moe else 64
    got = dryrun.step_flops(cfg, kind, B, S)
    want = dryrun._counted(cfg, kind, B, 1 if kind == "decode" else S, S)
    assert got["flops"] == want, (got, want)
    if cfg.is_moe and kind != "decode" and cfg.grad_accum == 1:
        assert got["rows"] < B  # counted at fewer rows, scaled exactly
    if name == "rwkv6_7b" and kind != "decode":
        assert got["seq"] == dryrun.RWKV_SEQ < S


def test_run_cell_writes_its_record(tmp_path):
    rec = dryrun.run_cell("smollm_135m", "train_4k", False, verbose=False,
                          out_dir=tmp_path)
    on_disk = json.loads((tmp_path / "smollm_135m__train_4k__16x16.json")
                         .read_text())
    assert on_disk == json.loads(json.dumps(rec))
    assert rec["chips"] == 256 and rec["collective_total_bytes"] > 0
    assert sorted(rec["collective_bytes"]) == sorted(dryrun.COLLECTIVES)
    assert rec["roofline"]["collective_s"] == pytest.approx(
        rec["collective_total_bytes"] / dryrun.LINK_BW)
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["collectives_counted"]["torch"] == torch.__version__
    assert rec["collectives_counted"]["upper_bound"] is False  # dense train
    assert rec["flops_per_device"] * 256 == pytest.approx(rec["flops_total"])
    assert rec["fits_80gb"] and rec["memory_per_device"]["opt"] > 0
    skip = dryrun.run_cell("smollm_135m", "long_500k", True, verbose=False,
                           out_dir=tmp_path)
    assert "skipped" in skip


def test_paper_cell_runs_the_sharded_sampler(tmp_path):
    rec = dryrun.run_paper_cell(False, scale=2_000, device="cpu",
                                out_dir=tmp_path)
    assert rec["entries"] == 16 and rec["per_shard_capacity"] > 0
    assert rec["join_size"] > 0 and rec["sample_count"] >= 0
    assert rec["peak_device_bytes"] is None
    assert rec["collective_total_bytes"] > 0


@pytest.mark.parametrize("mesh_flags", [[], ["--single-pod"], ["--multi-pod"]])
def test_both_is_the_default_meshes(monkeypatch, capsys, mesh_flags):
    """``--both`` (the reference's flag) is accepted and runs the cells the
    call without it runs: both meshes by default, and a mesh flag given
    beside it still picks its one mesh, as in the reference."""
    cells = []
    monkeypatch.setattr(dryrun, "count_cells",
                        lambda cs, meshes: ({c: None for c in cs}, {}))
    monkeypatch.setattr(dryrun, "run_cell", lambda a, s, mp, **kw:
                        cells.append((a, s, mp)))
    args = ["--arch", "smollm_135m", "--shape", "train_4k"] + mesh_flags
    assert dryrun.main(args) == 0
    without = list(cells)
    cells.clear()
    assert dryrun.main(["--both"] + args) == 0
    assert cells == without and len(without) == (1 if mesh_flags else 2)
    assert "all cells passed" in capsys.readouterr().out
