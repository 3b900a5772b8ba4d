"""On the card: one short run of each cell prints the result line the
benchmark's contract asks for, and a checkout without the program prints
none. ``python3 -m pytest portbench/tests -m card`` on the card's
machine; skipped without a card."""
import json
import shutil
import subprocess
import sys

import pytest

from portbench.lib import manifest

MAN = manifest.load()


def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def cell_run(cwd, cell, trace):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483647", "--seconds", "2", "--trace", str(trace)],
        cwd=cwd, capture_output=True, text=True, timeout=600)


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_a_cell_prints_its_result_line(cell):
    card()
    for trace in (0, 1):
        p = cell_run(manifest.ROOT, cell, trace)
        assert p.returncode == 0, p.stderr[-2000:]
        out = json.loads(p.stdout.strip().splitlines()[-1])
        assert out["correct"] is True
        assert list(out)[-1] == "checks"
        kind = "per_layer" if trace else "end_to_end"
        assert set(out["metrics"]) <= set(manifest.metric_names(MAN, cell,
                                                                kind))
        assert out["device"]["platform"] == "gpu"
        if trace:
            assert out["device"]["busy_s"] > 0


@pytest.mark.card
def test_without_the_program_no_result(tmp_path):
    card()
    shutil.copytree(manifest.HERE, tmp_path / manifest.HERE.name)
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    p = cell_run(tmp_path, MAN["workloads"][0]["name"], 0)
    assert p.returncode != 0 and p.stdout.strip() == ""
