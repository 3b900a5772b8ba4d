"""The dry run's collective bytes (``launch/comm_cost.py``,
``dryrun.step_collectives``) on the CPU, on ``meta`` DTensors over the
``fake`` backend:

  * ``comm_cost.collective_bytes`` on an op list equals the reference's
    ``launch.dryrun.collective_bytes`` on the same collectives written as
    HLO lines (result bytes, all-reduce twice);
  * a (1, 1) mesh moves nothing: 0 bytes for train, prefill and decode of
    three reduced configs;
  * ``layers.placements`` shards as ``NamedSharding`` does: every entry's
    block, a dimension over two mesh axes included, against DTensor's own
    offsets on each rank of a 2 x 2 x 2 mesh; ``mesh.device_mesh`` sets up
    and takes down the ``fake`` backend;
  * the cut-and-scaled count (``step_collectives``: repeats beyond two,
    encoder layers beyond two, RWKV's tokens) equals the full count;
  * the reference's FSDP rule in a step's collectives (reduced
    smollm-135m, (4, 2)): every weight sharded over "data" is all-gathered
    to its block on the other axes, and in training its gradient is
    reduce-scattered to its shard;
  * reduced configs on a (4, 2) mesh beside the reference's ``HloCost`` of
    the same step, compiled in a child process with 8 host devices. The
    partitioners choose their own layouts, so the totals are held within a
    factor: dense train and prefill (smollm-135m; 1.01x and 0.79x on torch
    2.13) within 0.5x-2x; the MoE layer and decode steps (olmoe-1b-7b
    train and decode, smollm-135m decode), which the counting route
    gathers whole, at or above the reference and under 4x (1.5x-2.4x).
    Both partitioners issue all-gathers (FSDP) and, in training,
    reductions.
"""
import dataclasses
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as tc
from repro_torch.launch import comm_cost, dryrun
from repro_torch.launch.mesh import Mesh, device_mesh, make_mesh
from repro_torch.models import layers

# the reference's dry run sets XLA_FLAGS for its own process on import:
# keep this one's as it was
_XLA_FLAGS = os.environ.get("XLA_FLAGS")
from repro.launch import dryrun as r_dryrun  # noqa: E402

if _XLA_FLAGS is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _XLA_FLAGS

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _reset_rules():
    yield
    layers.set_batch_axes(())
    layers.set_moe_ep(False)


def test_collective_bytes_are_the_references_rules():
    ops = [("all-reduce", "f32[4,32]", 512), ("all-gather", "bf16[8,16]", 256),
           ("reduce-scatter", "f32[2,3]", 24),
           ("all-to-all", "s32[5]", 20), ("all-reduce", "bf16[7]", 14),
           ("collective-permute", "f32[3,3]", 36)]
    hlo = "\n".join(f"  %op.{i} = {sig}{{1,0}} {name}(%p), replica_groups={{}}"
                    for i, (name, sig, _) in enumerate(ops))
    want, want_counts = r_dryrun.collective_bytes(hlo)
    got, counts = comm_cost.collective_bytes([(n, b) for n, _, b in ops])
    assert got == want and counts == want_counts
    assert got["all-reduce"] == 2 * (512 + 14)
    with pytest.raises(ValueError):
        comm_cost.collective_bytes([("broadcast", 4)])


@pytest.mark.parametrize("arch", ["smollm_135m", "olmoe_1b_7b",
                                  "whisper_small"])
def test_one_entry_moves_nothing(arch):
    cfg = tc.reduced(tc.get_config(arch))
    mesh = make_mesh((1, 1), ("data", "model"), devices="meta")
    layers.set_batch_axes(("data",))
    for kind in ("train", "prefill", "decode"):
        got = comm_cost.count_collectives(cfg, kind, 4, 32, mesh)
        assert sum(got["bytes"].values()) == 0, (kind, got)


def test_placements_shard_as_named_sharding():
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    shape, axes = (2, 2, 2), ("pod", "data", "model")
    grid = np.empty(8, dtype=object)
    grid[:] = [f"entry{i}" for i in range(8)]
    mesh = Mesh(grid.reshape(shape), axes)
    specs = [layers.P(("pod", "data"), "model"), layers.P("model", "data"),
             layers.P(None, ("data", "model")), layers.P("data")]
    tensor = (8, 12)
    for spec in specs:
        blocks = layers.NamedSharding(mesh, spec).blocks(tensor)
        want = {e: tuple(a for a, _ in key) for key, entries in blocks.items()
                for e in entries}
        plc = layers.placements(spec, mesh)
        for rank in range(8):
            with device_mesh(mesh, rank=rank) as dmesh:
                local, offset = compute_local_shape_and_global_offset(
                    tensor, dmesh, plc)
            assert tuple(local) == layers.NamedSharding(
                mesh, spec).shard_shape(tensor), spec
            assert tuple(offset) == want[f"entry{rank}"], (spec, rank)
    with pytest.raises(ValueError, match="order"):
        layers.placements(layers.P(("data", "pod")), mesh)


def test_device_mesh_on_the_fake_backend():
    """The ``fake`` backend is registered by a module of
    ``torch.testing._internal`` (``mesh._register_fake_backend``): if it
    moves, this fails with the module's name."""
    import torch.distributed as dist

    with device_mesh(make_mesh((2, 2), ("data", "model"),
                               devices="meta")) as dmesh:
        assert dmesh.mesh_dim_names == ("data", "model")
        assert dist.get_backend() == "fake" and dist.get_world_size() == 4
        with pytest.raises(RuntimeError, match="already exists"):
            with device_mesh(make_mesh((2,), ("data",), devices="meta")):
                pass
    assert not dist.is_initialized()


# (arch, kind, overrides): repeats beyond two, encoder layers beyond two,
# RWKV's tokens beyond RWKV_COUNT_SEQ
SCALED = {"repeats": ("smollm_135m", "train", {"n_layers": 4}),
          "encoder": ("whisper_small", "train", {"enc_layers": 4}),
          "rwkv": ("rwkv6_7b", "prefill", {})}


@pytest.mark.parametrize("case", sorted(SCALED))
def test_scaled_count_equals_the_full_count(case):
    name, kind, kw = SCALED[case]
    cfg = dataclasses.replace(tc.reduced(tc.get_config(name)), **kw)
    mesh = make_mesh((2, 2), ("data", "model"), devices="meta")
    S = 2 * dryrun.RWKV_COUNT_SEQ + 8 if name == "rwkv6_7b" else 16
    got = dryrun.step_collectives(cfg, kind, 32, S, mesh)
    want = comm_cost.count_collectives(cfg, kind, 32, S, mesh)["bytes"]
    assert got["bytes"] == {k: float(v) for k, v in want.items()}, (got,
                                                                   want)
    assert got["runs"] == 2
    assert sum(want.values()) > 0


def _fsdp_rule(cfg, mesh):
    """The reference's FSDP rule for ``cfg``'s parameters on ``mesh``:
    each parameter sharded over "data", its block with "data" gathered
    (an all-gather's result at its use) and its shard (the gradient's
    reduce-scatter's result), in bytes, as multisets."""
    from repro_torch.models import transformer

    model = transformer.init_model(cfg, device="meta", policy=dryrun.PLAIN)
    params = dict(model.named_parameters())
    specs = layers.sanitize_pspecs(layers.param_specs(model), params, mesh)
    gathers, shards = Counter(), Counter()
    for name, p in params.items():
        spec = specs[name]
        if "data" not in [a for e in spec for a in layers._axes(e)]:
            continue
        rest = layers.P(*[tuple(a for a in layers._axes(e) if a != "data")
                          or None for e in spec])
        size = p.element_size()
        gathers[("all-gather", size * int(np.prod(layers.NamedSharding(
            mesh, rest).shard_shape(p.shape))))] += 1
        shards[("reduce-scatter", size * int(np.prod(layers.NamedSharding(
            mesh, spec).shard_shape(p.shape))))] += 1
    return gathers, shards


def test_every_weight_is_gathered_and_its_gradient_reduce_scattered():
    cfg = tc.reduced(tc.get_config("smollm_135m"))
    mesh = make_mesh((4, 2), ("data", "model"), devices="meta")
    layers.set_batch_axes(("data",))
    gathers, shards = _fsdp_rule(cfg, mesh)
    assert sum(gathers.values()) == 2 * 7 + 1  # 7 matrices a block, embed
    for kind in ("train", "prefill"):
        ops = Counter(comm_cost.count_collectives(cfg, kind, 8, 64,
                                                  mesh)["ops"])
        want = gathers + (shards if kind == "train" else Counter())
        missing = {op: n - ops[op] for op, n in want.items() if ops[op] < n}
        assert not missing, (kind, missing)


# (arch, kind, B, S): held within 0.5x-2x of the reference's HloCost ...
DENSE = [("smollm_135m", "train", 8, 64), ("smollm_135m", "prefill", 8, 64)]
# ... and at or above it, under 4x: the MoE dispatch and decode's weights,
# which the counting route gathers whole (its upper bounds)
UPPER = [("olmoe_1b_7b", "train", 8, 64), ("olmoe_1b_7b", "decode", 8, 64),
         ("smollm_135m", "decode", 8, 64)]


@pytest.fixture(scope="module", autouse=True)
def reference():
    """The reference's ``HloCost`` by type of every cell of ``DENSE`` and
    ``UPPER`` on a (4, 2) host mesh, from a child process started with the
    module's first test (its compiles overlap the others) and read at the
    first call."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    child = subprocess.Popen(
        [sys.executable, "-c", _CHILD]
        + [":".join(map(str, c)) for c in DENSE + UPPER],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    got = {}

    def read(cell):
        if not got:
            out, err = child.communicate(timeout=300)
            assert child.returncode == 0, err[-3000:]
            got.update(json.loads(out.strip().splitlines()[-1]))
        return got[":".join(map(str, cell))]

    yield read
    if child.poll() is None:
        child.kill()
        child.communicate()


# the reference's run_cell on a (4, 2) host mesh of reduced configs: the
# step compiled by XLA, counted by HloCost
_CHILD = """
import json, sys
from functools import partial
import jax
jax.devices()  # the backend takes the 8 host devices before the import
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro import configs
from repro.launch import dryrun
from repro.launch.hlo_cost import COLLECTIVES, HloCost
from repro.models import layers, transformer
from repro.optim import AdamWConfig, adamw_init
mesh = Mesh(np.array(jax.devices()[:8]).reshape(4, 2), ("data", "model"))
out = {}
for cell in sys.argv[1:]:
    arch, kind, B, S = cell.split(":")
    B, S = int(B), int(S)
    cfg = configs.reduced(configs.get_config(arch))
    layers.set_batch_axes(("data",))
    layers.set_moe_ep(getattr(cfg, "moe_ep", False))
    params = jax.eval_shape(partial(transformer.init_model, cfg),
                            jax.random.key(0))
    pspecs = layers.sanitize_pspecs(layers.param_specs(params), params,
                                    mesh)
    pshard = jax.tree.map(lambda s: NamedSharding(mesh, s), pspecs,
                          is_leaf=lambda x: isinstance(x, P))
    specs = {"tokens": jax.ShapeDtypeStruct((B, 1 if kind == "decode"
                                             else S), np.int32)}
    if kind == "train":
        specs["targets"] = jax.ShapeDtypeStruct((B, S), np.int32)
    bshard = dryrun.batch_shardings(mesh, specs)
    with mesh:
        if kind == "train":
            opt_cfg = AdamWConfig(factored=cfg.opt_factored)
            opt = jax.eval_shape(partial(adamw_init, opt_cfg), params)
            oshard = {"step": NamedSharding(mesh, P()), "m": pshard,
                      "v": pshard}
            fn = jax.jit(dryrun.make_train_step(cfg, opt_cfg),
                         in_shardings=(pshard, oshard, bshard))
            lowered = fn.lower(params, opt, specs)
        elif kind == "prefill":
            fn = jax.jit(dryrun.make_prefill(cfg),
                         in_shardings=(pshard, bshard))
            lowered = fn.lower(params, specs)
        else:
            cache = jax.eval_shape(partial(transformer.init_cache, cfg, B,
                                           S, cfg.n_memory_tokens))
            fn = jax.jit(dryrun.make_serve_step(cfg), in_shardings=(
                pshard, dryrun.cache_shardings(mesh, cfg, cache),
                bshard["tokens"], NamedSharding(mesh, P())))
            lowered = fn.lower(params, cache, specs["tokens"],
                               jax.ShapeDtypeStruct((), np.int32))
    cost = HloCost(lowered.compile().as_text()).entry_cost()
    out[cell] = {k: float(cost[k]) for k in COLLECTIVES}
print(json.dumps(out))
"""


def _beside_the_reference(cell, want):
    arch, kind, B, S = cell
    cfg = tc.reduced(tc.get_config(arch))
    mesh = make_mesh((4, 2), ("data", "model"), devices="meta")
    layers.set_batch_axes(("data",))
    layers.set_moe_ep(getattr(cfg, "moe_ep", False))
    got = comm_cost.count_collectives(cfg, kind, B, S, mesh)["bytes"]
    ratio = sum(got.values()) / sum(want.values())
    print(f"reduced {arch} {kind} B {B} S {S} on (4, 2), torch "
          f"{torch.__version__}: port {got} (total {sum(got.values())}); "
          f"reference HloCost {want} (total {sum(want.values())}); "
          f"ratio {ratio:.3f}")
    assert sorted(got) == sorted(want)
    for side in (got, want):  # FSDP's gathers; training's reductions
        assert side["all-gather"] > 0, (cell, side)
        if kind == "train":
            assert side["all-reduce"] + side["reduce-scatter"] > 0, side
    return ratio


def test_reduced_smollm_beside_the_references_hlo_count(reference):
    for cell in DENSE:
        ratio = _beside_the_reference(cell, reference(cell))
        assert 0.5 <= ratio <= 2.0, (cell, ratio)


@pytest.mark.parametrize("cell", UPPER, ids=lambda c: f"{c[0]}-{c[1]}")
def test_upper_bounds_beside_the_references_hlo_count(reference, cell):
    ratio = _beside_the_reference(cell, reference(cell))
    assert 1.0 <= ratio < 4.0, (cell, ratio)


# the counting route's swaps, each architecture's own: dense attention and
# the plain routes (smollm), the sliding window (gemma3), routing and the
# dispatch (olmoe), the SSD scans (zamba2), the WKV scan (rwkv6), the
# encoder and cross attention (whisper)
VALUE_ARCHS = ["smollm_135m", "gemma3_1b", "olmoe_1b_7b", "zamba2_1p2b",
               "rwkv6_7b", "whisper_small"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", VALUE_ARCHS)
def test_the_counting_route_computes_the_plain_step(arch, kind):
    """On a (1, 1) mesh of real CPU tensors, where a DTensor is its whole
    tensor and nothing moves, the counting route (``comm_cost.run_step``)
    computes the dry run's step as the plain route does: the last logits
    of prefill and decode, the train step's loss and updated parameters,
    within 1e-5."""
    from repro_torch.models import transformer

    cfg = tc.reduced(tc.get_config(arch))
    mesh = make_mesh((1, 1), ("data", "model"), devices="meta")
    layers.set_batch_axes(("data",))
    B, S = 2, 16
    rng = np.random.default_rng(7)
    batch = {k: torch.from_numpy(rng.integers(1, cfg.vocab, v.shape))
             if not v.dtype.is_floating_point else
             torch.from_numpy(rng.standard_normal(v.shape, np.float32))
             for k, v in dryrun._inputs(cfg, kind, B, S).items()}

    def model():
        return transformer.init_model(cfg, 3, device="cpu",
                                      policy=dryrun.PLAIN)

    cache = None
    if kind == "decode":  # a cache of S - 1 decoded positions
        filler = model()
        cache = transformer.init_cache(cfg, B, S, cfg.n_memory_tokens,
                                       device="cpu")
        with torch.no_grad():
            for cur in range(S - 1):
                tokens = rng.integers(1, cfg.vocab, (B, 1))
                _, cache = transformer.decode_step(
                    filler, cache, torch.from_numpy(tokens), cur)

    def copied(c):
        return None if c is None else [
            {k: v.clone() for k, v in layer.items()} for layer in c]

    def results(m, out):
        if kind == "train":
            return [out[1]["loss"]] + [p.detach() for p in m.parameters()]
        return [out if kind == "prefill" else out[0]]

    plain = model()
    if kind == "train":
        from repro_torch.optim import AdamWConfig, adamw_init

        opt_cfg = AdamWConfig(factored=cfg.opt_factored)
        out = dryrun.make_train_step(cfg, opt_cfg)(
            plain, adamw_init(opt_cfg, dict(plain.named_parameters())),
            batch)
    elif kind == "prefill":
        out = dryrun.make_prefill(cfg)(plain, batch)
    else:
        out = dryrun.make_serve_step(cfg)(plain, copied(cache),
                                          batch["tokens"], S - 1)
    want = results(plain, out)
    counted = model()
    with device_mesh(mesh) as dmesh:
        out = comm_cost.run_step(cfg, kind, counted, dict(batch), mesh,
                                 dmesh, copied(cache), S - 1)
        got = [g.full_tensor() for g in results(counted, out)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.detach().double().numpy(),
                                   w.detach().double().numpy(),
                                   rtol=0, atol=1e-5)


def test_main_prints_a_step_a_line(capsys):
    assert comm_cost.main(["smollm_135m:prefill:4:16", "--mesh", "2,2"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    mesh = make_mesh((2, 2), ("data", "model"), devices="meta")
    layers.set_batch_axes(("data",))
    want = comm_cost.count_collectives(
        tc.reduced(tc.get_config("smollm_135m")), "prefill", 4, 16, mesh)
    assert line["bytes"] == want["bytes"] and line["torch"] == \
        torch.__version__ and line["total"] == sum(want["bytes"].values())
