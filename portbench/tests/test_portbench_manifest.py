"""The manifest: every entry resolves to its files, names and units keep
to the rules, and a new entry is found by name with no edit."""
import json
import shutil

import pytest

from portbench.lib import manifest

MAN = manifest.load()
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_the_manifest_keeps_to_the_rules():
    assert manifest.problems(MAN) == []


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_to_its_files(cell):
    r = manifest.resolve(MAN, cell)
    for key in ("gen", "reference", "driver"):
        assert r[key].is_file(), (cell, key)
    for path in list(r["end_to_end"].values()) + list(r["per_layer"].values()):
        assert path.is_file(), (cell, path)
    assert r["spec"]["config"] == r["cell"]["config"]
    assert r["spec"]["limits"], cell


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_names_and_units_use_the_allowed_characters(metric):
    m = {x["name"]: x for x in METRICS}[metric]
    assert manifest.NAME.match(m["name"])
    assert manifest.UNIT.match(m["unit"])
    assert all(c.isascii() for c in m["unit"] + m["name"])


def test_per_layer_metrics_move_what_their_cells_report():
    for m in MAN["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in manifest.metric_names(MAN, cell,
                                                        "end_to_end")
        assert not manifest.metric_names(MAN, "no-such-cell", "per_layer")


def test_the_command_names_only_files_under_paths():
    assert MAN["command"][:1] == ["python3"]
    for word in MAN["command"][1:]:
        assert word.startswith(tuple(p + "/" for p in MAN["paths"]))
        assert (manifest.ROOT / word).is_file()
    for p in MAN["paths"]:
        assert (manifest.ROOT / p).is_dir() and not p.startswith("/")


def test_a_full_check_fits_its_time():
    runs = 2 + 14 * 24
    total = runs * (MAN["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200 and 1 <= MAN["run_seconds"] <= 51


def test_every_config_names_its_source_and_cuts():
    for c in MAN["configs"]:
        conf = json.loads((manifest.ROOT / c["file"]).read_text())
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert set(conf["reduced_why"]) == set(c["reduced"])
        assert conf["guarantees"]["draw_precision"] in ("float64", "float32")


def test_a_dummy_entry_is_picked_up(tmp_path):
    """A configuration, a cell and a per-layer metric added as new files
    and manifest entries only: the loader finds them and a run reads the
    new metric."""
    import time

    import torch

    from portbench.lib.bench import run_cell

    root = tmp_path / "checkout"
    shutil.copytree(manifest.HERE, root / manifest.HERE.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = json.loads(json.dumps(MAN))
    here = root / manifest.HERE.name
    conf = json.loads((here / "configs" / "tpch-sf10.json").read_text())
    conf["name"] = "dummy"
    (here / "configs" / "dummy.json").write_text(json.dumps(conf))
    shutil.copy(here / "gen" / "tpch-sf10.py", here / "gen" / "dummy.py")
    spec = json.loads((here / "workloads" / "tpch-sf10.draws.json").read_text())
    spec.update(config="dummy", traffic="tiny", clients=2, max_batch=2,
                warm_batches=3, check_batches=1)
    (here / "workloads" / "dummy.tiny.json").write_text(json.dumps(spec))
    (here / "metrics" / "dummy_flushes.py").write_text(
        "def read(t):\n    return float(len([s for s in t.spans "
        "if s[0] == 'flush']))\n")
    man["configs"].append(dict(man["configs"][0], name="dummy",
                               file="portbench/configs/dummy.json"))
    man["workloads"].append({"name": "dummy.tiny", "config": "dummy",
                             "traffic": "tiny", "chips": 1,
                             "why": "a test's dummy cell"})
    for m in man["end_to_end"]:
        if "workloads" in m and "tpch-sf10.draws" in m["workloads"]:
            m["workloads"].append("dummy.tiny")
    man["per_layer"].append({"name": "dummy_flushes", "unit": "count",
                             "better": "lower", "source": "program_span",
                             "layer": "serving", "moves": "draws_per_s",
                             "workloads": ["dummy.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    assert manifest.problems(man, root) == []
    r = manifest.resolve(man, "dummy.tiny", root)
    assert r["gen"] == here / "gen" / "dummy.py"
    assert "dummy_flushes" in r["per_layer"]
    out = run_cell("dummy.tiny", 3, 0.3, True, torch.device("cpu"),
                   time.perf_counter(), root=root, scale=2e-4)
    assert out["correct"]
    assert out["metrics"]["dummy_flushes"]["value"] > 0
