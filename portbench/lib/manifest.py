"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) is ``workloads/<cell>.json``; its
configuration is the ``file`` of its ``configs`` entry, whose tables come
from ``gen/<config>.py`` and whose reference is ``reference/<name>.py``;
the cell's driver is ``drivers/<driver>.py``; an end-to-end metric is
``e2e/<metric>.py`` and a per-layer metric ``metrics/<metric>.py``. Adding
any of them takes new files and new manifest entries, no edit.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]   # portbench/
ROOT = HERE.parent                           # the checkout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path):
    """The Python file ``path`` as a module of its own (file names carry
    dots and dashes, so they are loaded by path, not imported)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_" + re.sub(r"\W", "_", path.stem), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def problems(man: dict, root: Path = ROOT) -> List[str]:
    """What in the manifest breaks the benchmark's rules or names a file
    that is not there (empty when all is well)."""
    here = root / HERE.name
    out = []
    if set(man) != TOP_KEYS:
        out.append(f"top-level keys {sorted(man)}")
    metrics = man.get("end_to_end", []) + man.get("per_layer", [])
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e.get("name", "") for e in man.get(kind, [])]
        if len(set(names)) != len(names):
            out.append(f"{kind}: a name twice")
        out += [f"{kind}: bad name {n!r}" for n in names if not NAME.match(n)]
    if len({m["name"] for m in metrics}) != len(metrics):
        out.append("a metric name twice")
    configs = {c["name"]: c for c in man.get("configs", [])}
    for c in configs.values():
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            out.append(f"config {c['name']}: keys {sorted(c)}")
        if not (root / c["file"]).is_file():
            out.append(f"config {c['name']}: no file {c['file']}")
        if not (here / "gen" / f"{c['name']}.py").is_file():
            out.append(f"config {c['name']}: no generator")
        out += [f"config {c['name']}: bad reduced key {k!r}"
                for k in c["reduced"] if not NAME.match(k)]
        out += [f"config {c['name']}: {f} not one line of 1-200"
                for f in ("source", "why") if not line(c[f])]
    cells = {w["name"]: w for w in man.get("workloads", [])}
    pairs = set()
    for w in cells.values():
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            out.append(f"cell {w['name']}: keys {sorted(w)}")
        if w["config"] not in configs:
            out.append(f"cell {w['name']}: unknown config {w['config']}")
        if w["chips"] not in (1, 4):
            out.append(f"cell {w['name']}: chips {w['chips']}")
        if not NAME.match(w["traffic"]):
            out.append(f"cell {w['name']}: bad traffic {w['traffic']!r}")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"cell {w['name']}: config and traffic twice")
        pairs.add((w["config"], w["traffic"]))
        if not line(w["why"]):
            out.append(f"cell {w['name']}: why not one line of 1-200")
        spec = here / "workloads" / f"{w['name']}.json"
        if not spec.is_file():
            out.append(f"cell {w['name']}: no {spec.name}")
            continue
        p = json.loads(spec.read_text())
        if p.get("config") != w["config"] or p.get("traffic") != w["traffic"]:
            out.append(f"cell {w['name']}: its file names another pair")
        if not (here / "drivers" / f"{p.get('driver')}.py").is_file():
            out.append(f"cell {w['name']}: no driver {p.get('driver')}")
    used = {w["config"] for w in cells.values()}
    out += [f"config {c}: no cell" for c in configs if c not in used]
    e2e = {m["name"]: m for m in man.get("end_to_end", [])}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in man.get("end_to_end", []):
        keys = {"name", "unit", "better", "bound", "source"}
        if not keys <= set(m) <= keys | {"workloads"}:
            out.append(f"metric {m['name']}: keys {sorted(m)}")
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"metric {m['name']}: source {m['source']}")
        if not 0 < m["bound"] <= 0.25:
            out.append(f"metric {m['name']}: bound {m['bound']}")
        if m["name"] != "setup_s" and not (here / "e2e" / f"{m['name']}.py").is_file():
            out.append(f"metric {m['name']}: no reader")
    for m in man.get("per_layer", []):
        keys = {"name", "unit", "better", "source", "layer", "moves"}
        if not keys <= set(m) <= keys | {"workloads"}:
            out.append(f"metric {m['name']}: keys {sorted(m)}")
        if m["moves"] not in e2e:
            out.append(f"metric {m['name']}: moves {m['moves']}")
        if not line(m["layer"]):
            out.append(f"metric {m['name']}: layer not one line")
        if not (here / "metrics" / f"{m['name']}.py").is_file():
            out.append(f"metric {m['name']}: no reader")
        for cell in m.get("workloads", []):
            if cell not in cells:
                out.append(f"metric {m['name']}: unknown cell {cell}")
            elif m["moves"] not in metric_names(man, cell, "end_to_end"):
                out.append(f"metric {m['name']}: {cell} lacks {m['moves']}")
    for m in metrics:
        if not UNIT.match(m.get("unit", "")):
            out.append(f"metric {m['name']}: bad unit {m.get('unit')!r}")
        if m.get("better") not in ("lower", "higher"):
            out.append(f"metric {m['name']}: better {m.get('better')}")
        if m.get("source") not in SOURCES:
            out.append(f"metric {m['name']}: source {m.get('source')}")
        for cell in m.get("workloads", []):
            if cell not in cells:
                out.append(f"metric {m['name']}: unknown cell {cell}")
    for cell in cells:
        if len(metric_names(man, cell, "end_to_end")) < 2:
            out.append(f"cell {cell}: no end-to-end metric but setup_s")
        if not metric_names(man, cell, "per_layer"):
            out.append(f"cell {cell}: no per-layer metric")
    return out


def metric_names(man: dict, cell: str, kind: str) -> List[str]:
    """The metrics of ``kind`` (``end_to_end`` or ``per_layer``) that
    ``cell`` reports: those that list it, and those that list no cells
    (a per-layer metric without a list goes with the cells of the metric
    it moves)."""
    e2e = metric_names(man, cell, "end_to_end") if kind == "per_layer" else None
    out = []
    for m in man[kind]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m["name"])
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m["name"])
    return out


def resolve(man: dict, cell: str, root: Path = ROOT) -> Dict[str, object]:
    """Everything one run of ``cell`` needs, found by name."""
    here = root / HERE.name
    cells = {w["name"]: w for w in man["workloads"]}
    if cell not in cells:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    entry = cells[cell]
    conf_entry = {c["name"]: c for c in man["configs"]}[entry["config"]]
    spec = json.loads((here / "workloads" / f"{cell}.json").read_text())
    config = json.loads((root / conf_entry["file"]).read_text())
    return {
        "cell": entry, "spec": spec, "config": config,
        "gen": here / "gen" / f"{entry['config']}.py",
        "reference": here / "reference" / f"{config['reference']}.py",
        "driver": here / "drivers" / f"{spec['driver']}.py",
        "end_to_end": {m: here / "e2e" / f"{m}.py"
                       for m in metric_names(man, cell, "end_to_end")
                       if m != "setup_s"},
        "per_layer": {m: here / "metrics" / f"{m}.py"
                      for m in metric_names(man, cell, "per_layer")},
        "units": {m["name"]: m["unit"]
                  for m in man["end_to_end"] + man["per_layer"]},
    }
