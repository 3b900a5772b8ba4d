"""The port's tile tuning (``repro_torch.kernels.autotune``) against the
reference's (``repro.kernels.autotune``), on the CPU.

  * ``bucket_of`` and the ladder (override > table: the backend's entry,
    then ``default``; the bucket, then ``'*'`` > builtin; ``tuned=False``
    the builtin) resolve as the reference's on the same table.
  * ``sweep`` with an injected timer picks the fastest candidate, timing
    each once; a written table round-trips and passes ``--check``;
    ``check_table`` gives the reference's verdict on the same malformed
    tables; the committed table passes ``python -m ... --check``.
  * The ``default`` entry is the kernels' tiles before tuning, read from
    the ``#define`` and ``constexpr`` lines of ``csrc/``.
  * At every candidate tile the plain models of the GET and the bsearch
    (``tree_walk_tiled``, ``bsearch_probe_tiled``) equal the reference's
    kernels bit for bit, at a ragged size.
  * The ops wrappers' explicit ``block_*`` arguments reach the launched
    instance, and a value that names no instance raises.

The kernels themselves run only on a card, where ``chip_smoke.py`` phase
L holds every candidate instance against its plain version.
"""
import contextlib
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import config as r_config
from repro.core import build_shred
from repro.kernels import autotune as r_at
from repro.kernels.bsearch_probe import bsearch_probe as r_bsearch
from repro.kernels.tree_probe import tree_probe as r_tree_probe
from repro_torch.config import KernelPolicy, backend_key
from repro_torch.core import shred_from_arrays
from repro_torch.kernels import autotune as t_at
from repro_torch.kernels import bsearch_probe as t_bp
from repro_torch.kernels import build
from repro_torch.kernels import flash_decode as t_fd
from repro_torch.kernels import flash_prefill as t_fp
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import tree_probe as t_tp

from test_torch_paged import setup
from test_torch_shred import ref_arrays

ROOT = Path(__file__).resolve().parents[1]
# a probe count that is no multiple of any candidate tile (256 to 2,048)
RAGGED = 2 * 2048 + 37


def _defines(name: str) -> dict:
    text = (build.CSRC / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"^#define (\w+) (\d+)", text, re.M)}


# --- buckets and the ladder -----------------------------------------------------

def test_bucket_of_matches_reference():
    sizes = list(range(0, 4097)) + [2 ** k + d for k in range(13, 32)
                                    for d in (-1, 0, 1)]
    assert [t_at.bucket_of(n) for n in sizes] == [
        r_at.bucket_of(n) for n in sizes]


# a table whose values are instances of the port and shapes of the
# reference: both packages resolve it the same way
TABLE = {"version": 1, "entries": {
    "cpu/cpu": {"tree_probe": {"p9": 4, "p14": 16},
                "bsearch_probe": {"*": 2},
                "flash_prefill": {"p10": [64, 128]}},
    "default": {"tree_probe": {"*": 8}, "tree_probe_paged": {"*": 16},
                "bsearch_probe": {"*": 8}, "flash_decode": {"*": 256},
                "flash_prefill": {"*": [128, 64]}}}}


@pytest.fixture
def table(tmp_path, monkeypatch):
    path = tmp_path / "TUNE_TABLE.json"
    path.write_text(json.dumps(TABLE))
    monkeypatch.setattr(t_at, "TABLE_PATH", path)
    monkeypatch.setattr(r_at, "TABLE_PATH", path)
    return path


LADDER = [("tree_probe", 512), ("tree_probe", 300), ("tree_probe", 1 << 14),
          ("tree_probe", 1 << 20), ("tree_probe_paged", 512),
          ("bsearch_probe", 7), ("flash_decode", 2048),
          ("flash_prefill", 1024), ("flash_prefill", 4096)]


@pytest.mark.parametrize("kernel,size", LADDER)
def test_ladder_matches_reference(table, kernel, size):
    got = t_at.tile_for(kernel, size, device="cpu")
    want = r_at.tile_for(kernel, size, r_config.current_policy())
    assert got == want


def test_ladder_rungs(table):
    tile = t_at.tile_for
    # the backend's bucket, then its '*', then the default entry
    assert tile("tree_probe", 512, device="cpu") == 4
    assert tile("tree_probe", 5000, device="cpu") == 8
    assert tile("bsearch_probe", 12345, device="cpu") == 2
    assert tile("flash_prefill", 1000, device="cpu") == (64, 128)
    assert tile("flash_prefill", 3000, device="cpu") == (128, 64)
    # another card's key falls to the default entry
    assert backend_key("cpu") == "cpu/cpu"
    # an override wins; tuned=False is the builtin
    pin = KernelPolicy(tile_overrides=(("tree_probe", 2),
                                       ("flash_prefill", (64, 64))))
    assert tile("tree_probe", 512, pin, "cpu") == 2
    assert tile("flash_prefill", 1000, pin, "cpu") == (64, 64)
    assert tile("bsearch_probe", 7, pin, "cpu") == 2
    off = KernelPolicy(tuned=False)
    assert [tile(k, 512, off, "cpu") for k in t_at.KERNELS] == [
        spec.default for spec in t_at.KERNELS.values()]
    assert tile("tree_probe", 512, KernelPolicy(
        tuned=False, tile_overrides=(("tree_probe", 16),)), "cpu") == 16
    # a policy stays hashable with its pins; a pin may be a JSON list
    assert hash(pin) == hash(KernelPolicy(tile_overrides=pin.tile_overrides))
    assert tile("flash_prefill", 1000, KernelPolicy(tile_overrides=(
        ("flash_prefill", [128, 64]),)), "cpu") == (128, 64)


def test_missing_table_resolves_builtin(tmp_path, monkeypatch):
    monkeypatch.setattr(t_at, "TABLE_PATH", tmp_path / "none.json")
    assert [t_at.tile_for(k, 512, device="cpu") for k in t_at.KERNELS] == [
        spec.default for spec in t_at.KERNELS.values()]


# --- the sweep, the table and --check -------------------------------------------

def test_sweep_picks_fastest_candidate():
    times = iter([250.0, 100.0])  # the second candidate wins
    calls = []

    def timer(fn):
        calls.append(fn)
        return next(times)

    winners = t_at.sweep(["bsearch_probe"], timer=timer,
                         candidates={"bsearch_probe": (4, 8)},
                         sizes={"bsearch_probe": (128,)}, rounds=1,
                         device="cpu", out=lambda s: None)
    assert winners == {"bsearch_probe": {"p7": 8}}
    assert len(calls) == 2
    # a thunk launches its candidate (the plain version on the CPU)
    assert calls[0]().dtype == torch.int32


def test_sweep_write_roundtrip_and_check(tmp_path):
    path = tmp_path / "TUNE_TABLE.json"
    seq = iter([50.0, 75.0, 9.0, 3.0, 5.0])
    t_at.sweep(["bsearch_probe", "flash_decode"], timer=lambda fn: next(seq),
               candidates={"bsearch_probe": (4, 8)},
               sizes={"bsearch_probe": (128,), "flash_decode": (100,)},
               rounds=1, entry_key="faux/devkind", write=True, path=path, device="cpu",
               out=lambda s: None)
    table = t_at.load_table(path)
    assert table["version"] == t_at.TABLE_VERSION
    assert table["entries"]["faux/devkind"] == {
        "bsearch_probe": {"p7": 4}, "flash_decode": {"p7": 128}}
    assert table["entries"]["default"] == json.loads(json.dumps(
        t_at.default_entry()))
    assert t_at.check_table(path, out=lambda s: None) == 0
    assert r_at.check_table(path, out=lambda s: None) == 0


# (us of candidate 4, us of the builtin 8) a round -> the tile kept
ROUNDS = {
    "a lead in every round": ([(10.0, 20.0), (12.0, 19.0)], 4),
    "the rounds' winners differ": ([(10.0, 20.0), (20.0, 10.0)], 8),
    "a lead within the spread": ([(10.0, 11.0), (12.0, 13.0)], 8),
    "the builtin wins": ([(30.0, 20.0), (31.0, 19.0)], 8),
}


@pytest.mark.parametrize("case", list(ROUNDS))
def test_sweep_rounds_keep_a_tile_only_on_a_repeated_lead(tmp_path, case):
    rounds, kept = ROUNDS[case]
    seq = iter([us for pair in rounds for us in pair])
    path = tmp_path / "TUNE_TABLE.json"
    # an earlier sweep's row goes: a swept kernel's rows are replaced
    path.write_text(json.dumps({"version": 1, "entries": {
        "faux/devkind": {"bsearch_probe": {"p14": 2}}}}))
    winners = t_at.sweep(["bsearch_probe"], timer=lambda fn: next(seq),
                         candidates={"bsearch_probe": (4, 8)},
                         sizes={"bsearch_probe": (128,)}, rounds=2,
                         entry_key="faux/devkind", write=True, path=path,
                         device="cpu", out=lambda s: None)
    assert winners == {"bsearch_probe": {"p7": kept}}
    assert t_at.load_table(path)["entries"]["faux/devkind"] == {
        "bsearch_probe": {"p7": kept}}


def test_tile_for_reads_the_table_once(tmp_path, monkeypatch):
    """A kernel call resolves its tile from memory: the table (present or
    not) is read once a process and path, and a write is seen."""
    path = tmp_path / "TUNE_TABLE.json"
    monkeypatch.setattr(t_at, "TABLE_PATH", path)
    t_at._load_raw.cache_clear()
    reads = t_at._load_raw.cache_info().misses
    for _ in range(3):
        assert t_at.tile_for("tree_probe", 512, device="cpu") == 8
        assert t_at.tile_for("tree_probe", 600, device="cpu") == 8
    assert t_at._load_raw.cache_info().misses == reads + 1
    t_at.sweep(["tree_probe"], timer=lambda fn: 1.0,
               candidates={"tree_probe": (4,)},
               sizes={"tree_probe": (512,)}, entry_key="cpu/cpu",
               write=True, path=path, device="cpu", out=lambda s: None)
    assert t_at.tile_for("tree_probe", 512, device="cpu") == 4


def _bad_tables():
    good = {"version": 1, "entries": {"default": t_at.default_entry()}}

    def edit(fn):
        t = json.loads(json.dumps(good))
        fn(t)
        return t

    return {
        "good": good,
        "version": edit(lambda t: t.update(version=2)),
        "no default": edit(lambda t: t["entries"].pop("default")),
        "unknown kernel": edit(lambda t: t["entries"]["default"].update(
            flash_attention={"*": 8})),
        "bad bucket": edit(lambda t: t["entries"]["default"]["tree_probe"]
                           .update(q9=8)),
        "int for a pair": edit(lambda t: t["entries"]["default"][
            "flash_prefill"].update(p10=128)),
        "pair for an int": edit(lambda t: t["entries"]["default"][
            "tree_probe"].update(p9=[8, 8])),
        "default row missing": edit(lambda t: t["entries"]["default"].pop(
            "flash_decode")),
    }


@pytest.mark.parametrize("case", list(_bad_tables()))
def test_check_table_verdicts_match_reference(tmp_path, case):
    path = tmp_path / "TUNE_TABLE.json"
    path.write_text(json.dumps(_bad_tables()[case]))
    want = r_at.check_table(path, out=lambda s: None)
    assert t_at.check_table(path, out=lambda s: None) == want
    assert want == (0 if case == "good" else 1)


def test_check_table_refuses_a_value_that_names_no_instance(tmp_path):
    t = {"version": 1, "entries": {"default": t_at.default_entry()}}
    t["entries"]["default"]["tree_probe"]["p9"] = 32
    path = tmp_path / "TUNE_TABLE.json"
    path.write_text(json.dumps(t))
    lines = []
    assert t_at.check_table(path, out=lines.append) == 1
    assert "names no instance" in "\n".join(lines)


def test_committed_table_passes_check():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run(
        [sys.executable, "-m", "repro_torch.kernels.autotune", "--check"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stdout + done.stderr
    assert "autotune --check: ok" in done.stdout
    table = t_at.load_table()
    assert table["entries"]["default"] == json.loads(json.dumps(
        t_at.default_entry()))


# --- the default entry is the kernels' tiles before tuning ------------------------

def test_default_entry_is_the_sources_tiles():
    get, bp = _defines("tree_get.cuh"), _defines("bsearch_probe.cu")
    dec, pre = _defines("flash_decode.cu"), _defines("flash_prefill_tc.cu")
    f32 = _defines("flash_prefill.cu")
    default = {k: v["*"] for k, v in t_at.default_entry().items()}
    for kernel in ("tree_probe", "tree_probe_paged"):
        assert default[kernel] * 128 == get["TG_THREADS"] * get["TG_ITEMS"]
    assert default["bsearch_probe"] * 128 == get["TG_THREADS"] * bp["BP_ITEMS"]
    assert default["flash_decode"] == dec["FDT_TK"]
    assert default["flash_prefill"] == (pre["FPT_BQ"], pre["FPT_BK"])
    assert t_bp.items_for(None) == t_bp.items_for(8) == bp["BP_ITEMS"]
    # the GET's probes a thread by tree size, as before tuning
    # (tree_get.cu's instance rule: 4 up to four nodes, 2 up to eight, 1)
    assert [t_tp.items_for(s, default["tree_probe"])
            for s in (1, 2, 4, 5, 8, 9, 16)] == [4, 4, 4, 2, 2, 1, 1]
    # attention: each head dim's tile before tuning, from one value
    src = (build.CSRC / "flash_prefill_tc.cu").read_text()
    assert "fpt_smem(D, BQ, BK, 3) <= FPT_SMEM_MAX ? 3 : 2" in src
    bf16, f32t = torch.bfloat16, torch.float32
    assert {D: t_fp.prefill_config(bf16, D)
            for D in t_fp.HEAD_DIMS[bf16]} == {
        64: {"block_q": 128, "block_k": 128, "stages": 3},
        128: {"block_q": 128, "block_k": 128, "stages": 3},
        256: {"block_q": 128, "block_k": 64, "stages": 2}}
    assert {D: t_fp.instance(f32t, D) for D in t_fp.HEAD_DIMS[f32t]} == {
        D: (f32["FP_BQ"], bk) for D, (_, _, bk) in t_fp.F32_SHAPES.items()}
    assert {D: t_fd.instance(bf16, D) for D in t_fd.HEAD_DIMS[bf16]} == {
        D: dec["FDT_TK"] for D in t_fd.HEAD_DIMS[bf16]}
    assert {D: t_fd.instance(f32t, D)
            for D in t_fd.HEAD_DIMS[f32t]} == t_fd.F32_TILE_KEYS


def test_instances_mirror_the_sources():
    """The wrappers' instance tables are the launchers' dispatch: the bf16
    tiles where shared memory allows, the float32 specializations."""
    dec = (build.CSRC / "flash_decode.cu").read_text()
    dd, pd = _defines("flash_decode.cu"), _defines("flash_prefill_tc.cu")
    tk = dd["FDT_TK"]
    assert [tk if t == "FDT_TK" else int(t) for t in re.findall(
        r"fdt_instance<D, (\w+)>\(", dec)] == list(t_fd.TC_INSTANCES[64])
    # the tables are the sources' shared-memory rules (copied here, and
    # held to the sources' text): bf16 decode builds an instance where
    # three stages fit, bf16 prefill where two do, with three where three
    assert "FDT_M * CH * 16 + FDT_STAGES * STAGE_BYTES" in dec
    assert "FdtShape<D, 128>::SMEM <= FDT_SMEM_MAX" in dec

    def dec_smem(D, tk):  # FdtShape<D, TK>::SMEM
        return dd["FDT_M"] * D * 2 + dd["FDT_STAGES"] * (2 * tk * D * 2
                                                         + tk * 4)

    assert t_fd.TC_STAGES == dd["FDT_STAGES"]
    assert t_fd.TC_INSTANCES == {D: tuple(
        t for t in (64, 128, 256) if dec_smem(D, t) <= dd["FDT_SMEM_MAX"])
        for D in t_fd.HEAD_DIMS[torch.bfloat16]}
    pre = (build.CSRC / "flash_prefill_tc.cu").read_text()
    assert ("return 1024 + BQ * D * 2 + 2 * stages * BK * D * 2 + "
            "8 * (1 + 2 * stages);") in pre

    def pre_smem(D, bq, bk, stages):  # fpt_smem
        return 1024 + bq * D * 2 + 2 * stages * bk * D * 2 + 8 * (
            1 + 2 * stages)

    cap = pd["FPT_SMEM_MAX"]
    assert t_fp.TC_INSTANCES == {
        (D, bq, bk): 3 if pre_smem(D, bq, bk, 3) <= cap else 2
        for D in t_fp.HEAD_DIMS[torch.bfloat16] for bq in (64, 128)
        for bk in (64, 128)
        if pre_smem(D, bq, bk, 2) <= cap}
    assert {D: sorted({t_fp.instance(torch.bfloat16, D, *c)
                       for c in t_at.KERNELS["flash_prefill"].candidates})
            for D in t_fp.HEAD_DIMS[torch.bfloat16]} == {
        64: [(64, 64), (64, 128), (128, 64), (128, 128)],
        128: [(64, 64), (64, 128), (128, 64), (128, 128)],
        256: [(64, 64), (128, 64)]}
    pre = (build.CSRC / "flash_prefill.cu").read_text()
    assert sorted((int(d), int(bk)) for d, bk in re.findall(
        r"fp_instance<(\d+), (\d+)>\(", pre)) == sorted(t_fp.F32_INSTANCES)
    get = (build.CSRC / "tree_get.cu").read_text()
    assert "return slots <= 4 ? 8 : slots <= 8 ? 2 : 1;" in (
        build.CSRC / "tree_get.cuh").read_text()
    assert [t_tp.max_items(s) for s in (2, 4, 5, 8, 9, 16)] == [
        8, 8, 2, 2, 1, 1]
    # one kernel, one grid: the paged GET's tiles are the GET's
    assert t_at.KERNELS["tree_probe"] == t_at.KERNELS["tree_probe_paged"]
    assert "tree_get_kernel<MAXS, 8, 2>" in get
    bp = (build.CSRC / "bsearch_probe.cu").read_text()
    assert re.findall(r"case (\d+): return bsearch_probe_kernel<\1>", bp) == [
        "1", "2", "4", "8"]
    assert [t_bp.items_for(b) for b in (2, 4, 8, 16)] == [1, 2, 4, 8]


# --- every candidate tile, the plain models against the reference ------------------

def test_tree_walk_tiled_at_every_tile_matches_reference():
    """The chain of ``test_torch_paged.py`` (``test_torch_tree_get.py``
    runs the other trees at the kernel's tile and smaller ones)."""
    _, q, _, rdb, _ = setup("chain")
    ref = build_shred(rdb, q)
    port = shred_from_arrays(ref_arrays(ref), device="cpu")
    n = int(ref.join_size)
    pos = np.sort(np.random.default_rng(5).integers(0, n, RAGGED)).astype(
        np.int32)
    tiles = np.pad(pos, (0, (-RAGGED) % 128),
                   constant_values=pos[-1]).reshape(-1, 128)
    want = np.asarray(r_tree_probe(
        ref.packed.arena, jnp.asarray(tiles), layout=ref.packed.layout,
        block_rows=8, interpret=True)).reshape(
            ref.packed.layout.num_slots, -1)[:, :RAGGED]
    layout = port.packed.layout
    for br in t_at.KERNELS["tree_probe"].candidates:
        tile = t_tp.THREADS * t_tp.items_for(layout.num_slots, br)
        for order in (slice(None), np.random.default_rng(br).permutation(
                RAGGED)):
            got = t_tp.tree_walk_tiled(port.packed.arena,
                                       torch.from_numpy(pos[order]), layout,
                                       tile=tile)
            np.testing.assert_array_equal(torch.stack(got).numpy(),
                                          want[:, order])


def test_bsearch_probe_tiled_at_every_tile_matches_reference():
    rng = np.random.default_rng(9)
    pref = np.concatenate([[0], np.cumsum(rng.integers(0, 4, 3000))]).astype(
        np.int32)
    q = rng.integers(0, int(pref[-1]) + 3, RAGGED).astype(np.int32)
    tiles = np.pad(q, (0, (-RAGGED) % 128), constant_values=q[-1])
    want = np.asarray(r_bsearch(jnp.asarray(pref), jnp.asarray(
        tiles.reshape(-1, 128)), block_rows=8, interpret=True)).reshape(-1)
    want = want[:RAGGED]
    tp = torch.from_numpy(pref)
    for br in t_at.KERNELS["bsearch_probe"].candidates:
        for qq, ww in ((q, want), (np.sort(q), np.sort(want))):
            stats = {}
            got = t_bp.bsearch_probe_tiled(tp, torch.from_numpy(qq),
                                           tile=128 * br, stats=stats)
            np.testing.assert_array_equal(got.numpy(), ww)
            assert stats["tiles"] == -(-RAGGED // (128 * br))
        # the wrapper's CPU route takes the same tile for its stats
        stats = {}
        t_bp.bsearch_probe(tp, torch.from_numpy(q), stats=stats,
                           block_rows=br)
        assert stats["tiles"] == -(-RAGGED // (128 * br))


@pytest.mark.parametrize("instance", sorted(t_fp.F32_INSTANCES))
def test_every_float32_prefill_instance_emulated(instance):
    """Each float32 prefill instance's tiling (its warps' rows and key
    blocks, the key warps' merge) against the plain version at a ragged
    S, causal and not."""
    from test_torch_attention_f32 import PREFILL_TOL, _close, \
        prefill_f32_emulated
    D = instance[0]
    g = torch.Generator().manual_seed(D)
    q, k, v = (torch.randn(s, generator=g) for s in
               ((1, 2, 97, D), (1, 1, 97, D), (1, 1, 97, D)))
    for causal in (True, False):
        got = prefill_f32_emulated(q, k, v, causal,
                                   t_fp.F32_INSTANCES[instance])
        _close(got, t_fp.flash_prefill_plain(q, k, v, causal), PREFILL_TOL)


# --- the ops wrappers: explicit tiles reach the launch ------------------------------

def _record(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def fake(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)
    monkeypatch.setattr(module, name, fake)


def test_explicit_blocks_reach_the_instance(monkeypatch, table):
    calls = []
    _record(monkeypatch, t_fp, "flash_prefill", calls)
    _record(monkeypatch, t_ops, "flash_decode", calls)
    _record(monkeypatch, t_ops, "bsearch_probe", calls)
    x = torch.randn(1, 2, 40, 64)
    t_ops.prefill_attention(x, x, x)                         # the table's
    t_ops.prefill_attention(x, x, x, block_q=64)             # pins its axis
    t_ops.prefill_attention(x, x, x, block_q=128, block_k=128)
    t_ops.decode_attention(x[:, :, 0], x, x)
    t_ops.decode_attention(x[:, :, 0], x, x, block_s=128)
    pref = torch.arange(0, 100, dtype=torch.int32)
    t_ops.searchsorted_prefix(pref, torch.arange(7, dtype=torch.int32))
    t_ops.searchsorted_prefix(pref, torch.arange(7, dtype=torch.int32),
                              KernelPolicy(tile_overrides=(
                                  ("bsearch_probe", 16),)))
    got = [a[4:] + tuple(k.values()) for a, k in calls]
    got = [g[1:] if isinstance(g[0], bool) else g for g in got]
    # S = 40: the default entry's (128, 64) (cpu/cpu's row is for S in
    # (512, 1024]) and 256; seven queries: cpu/cpu's 2; then the pins
    assert got == [(128, 64), (64, 64), (128, 128), (256,), (128,), (2,),
                   (16,)]


def test_a_value_that_names_no_instance_raises():
    x = torch.randn(1, 2, 40, 64)
    with pytest.raises(ValueError, match="names no instance"):
        t_ops.prefill_attention(x, x, x, block_k=256)
    with pytest.raises(ValueError, match="names no instance"):
        t_ops.prefill_attention(x, x, x, block_q=32)
    with pytest.raises(ValueError, match="names no instance"):
        t_ops.decode_attention(x[:, :, 0], x, x, block_s=512)
    pref = torch.arange(0, 100, dtype=torch.int32)
    with pytest.raises(ValueError, match="names no instance"):
        t_bp.bsearch_probe(pref, pref, block_rows=3)
    with pytest.raises(ValueError, match="names no instance"):
        t_ops.searchsorted_prefix(pref, pref, KernelPolicy(
            tile_overrides=(("bsearch_probe", 32),)))
    layout = types.SimpleNamespace(num_slots=3)
    with pytest.raises(ValueError, match="names no instance"):
        t_tp.items_for(layout.num_slots, 32)
    with pytest.raises(ValueError, match="names no instance"):
        t_fd.instance(torch.bfloat16, 64, 32)
    with pytest.raises(ValueError, match="want an int"):
        t_at.check_value("flash_decode", "64")


def test_instance_clamps_per_head_dim_and_dtype():
    bf16, f32 = torch.bfloat16, torch.float32
    # bf16 prefill at D 256 keeps keys tiles of 64; float32 rows are 64
    assert t_fp.instance(bf16, 256, 64, 128) == (64, 64)
    assert t_fp.prefill_config(bf16, 256, 64, 64)["stages"] == 3
    assert t_fp.instance(f32, 64, 128, 64) == (64, 64)
    assert t_fp.instance(f32, 128, 128, 128) == (64, 64)
    assert t_fp.instance(f32, 256, 64, 64) == (64, 32)
    # bf16 decode stages: the largest that fits three in shared memory
    assert [t_fd.instance(bf16, D, 256) for D in (64, 128, 256)] == [
        256, 128, 64]
    assert [t_fd.instance(f32, D, 256) for D in (64, 128, 256)] == [
        64, 32, 16]
    assert t_fd.decode_config(bf16, 64, 128) == {"block_s": 128, "stages": 3}
    # the GET: a tree of more nodes keeps fewer probes a thread
    assert [t_tp.items_for(s, 16) for s in (3, 6, 12)] == [8, 2, 1]
    assert [t_tp.items_for(3, b) for b in (2, 4, 8, 16)] == [1, 2, 4, 8]


# --- the launches pass the instance to the C entries (a fake card) ------------------

class _Lib:
    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __getattr__(self, symbol):
        def entry(*args):
            self.calls.append((self.name, symbol, args))
            if symbol.endswith("_config"):
                cfg = args[-2]
                cfg[:] = [4, 2, 132, 1024]
            return 0
        return entry


@pytest.fixture
def fake_card(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "library", lambda name: _Lib(name, calls))
    monkeypatch.setattr(build, "_ENTRIES", {})
    monkeypatch.setattr(build, "current_stream", lambda d: 0)
    monkeypatch.setattr(t_bp, "_CONFIGS", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    return calls


def test_launches_pass_the_tile_last(fake_card):
    pref = torch.arange(0, 100, dtype=torch.int32)
    for items in (1, 8):
        t_bp._launch(pref, torch.arange(3000, dtype=torch.int32), None,
                     items)
    launches = [a for _, s, a in fake_card if s == "bsearch_probe_launch"]
    configs = [a for _, s, a in fake_card if s == "bsearch_probe_config"]
    assert [a[-1] for a in launches] == [1, 8]
    assert [a[-1] for a in configs] == [1, 8]
    q = torch.zeros((1, 4, 50, 64), dtype=torch.bfloat16)
    t_fp._launch(q, q[:, :2].clone(), q[:, :2].clone(), True, (64, 128))
    t_fp._launch(q.float(), q[:, :2].float(), q[:, :2].float(), True,
                 (64, 64))
    t_fd._launch(q[:, :, 0], q[:, :2].clone(), q[:, :2].clone(),
                 torch.zeros((1, 50)), 2, 256)
    tails = [(s, a[-2:]) for _, s, a in fake_card if "flash" in s]
    assert tails == [("flash_prefill_tc_launch", (64, 128)),
                     ("flash_prefill_launch", (0, 64)),
                     ("flash_decode_tc_launch", (0, 256))]
