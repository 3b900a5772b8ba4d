#!/usr/bin/env python3
"""The control of ``correct``: the plain reference in the program's place,
computed one precision below the one the configuration states, run
through the same window and judge. It has to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \\
        [--seconds 5] [--dtype float32|bfloat16|float64] \\
        [--fault mean_p|next_p]

``--dtype`` defaults to the precision below the configuration's
``draw_precision`` (float32 below float64, bfloat16 below float32);
``float64`` runs the reference at full precision, which has to come out
correct. ``--fault`` plants a fault in the reference's draws at full
precision: ``mean_p`` keeps every row with the join's mean p (so E[k]
stays), ``next_p`` with the p of the next root row; the rows reported at
the drawn positions stay the table's. One JSON line a seed: its numbers
beside the cell's limits. The benchmark's own runs never run this.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path[:0] = [str(Path(__file__).resolve().parents[1]),
                str(Path(__file__).resolve().parents[1] / "src")]

BELOW = {"float64": "float32", "float32": "bfloat16"}


class ControlStats:
    shred_builds = plan_misses = 0

    def snapshot(self):
        return self


class ReferenceEngine:
    """The reference as an engine: draws by ``reference.star``'s plain
    sampler and full joins by its rows, every float computed in ``dtype``;
    deltas replayed by its ``apply_delta``. With a ``fault``, the draws
    take their rows' p wrongly (``mean_p`` or ``next_p``)."""

    def __init__(self, ref, tables, config, dtype, device, fault=None):
        import torch

        self.ref, self.config, self.device = ref, config, device
        self.fault = fault
        self.dtype = getattr(torch, dtype)
        self.tables = {rel: {c: torch.as_tensor(v).to(device)
                             for c, v in cols.items()}
                       for rel, cols in tables.items()}
        self.stats = ControlStats()
        self.db = SimpleNamespace(version=0, relations={})
        self._star()

    def _star(self):
        q = self.config["query"]
        self.star = self.ref.Star(self.tables, q["atoms"], q["prob_var"])
        self.drawn = self.star
        if self.fault:
            import copy

            import torch

            p, w = self.star.p, self.star.w.to(torch.float64)
            self.drawn = copy.copy(self.star)
            if self.fault == "mean_p":
                self.drawn.p = torch.full_like(p, float((w * p).sum()
                                                        / w.sum()))
            else:
                self.drawn.p = torch.roll(p, -1)
        self.db.relations = {rel: SimpleNamespace(columns=cols)
                             for rel, cols in self.tables.items()}

    def compile(self, query):
        return None

    def _rows(self, pos):
        import torch

        rows = self.star.rows_at(pos)
        pv = self.config["query"]["prob_var"]
        rows[pv] = rows[pv].to(self.dtype).to(torch.float64)
        return rows

    def sample_batch(self, query, keys, **kw):
        import numpy as np
        import torch

        draws = []
        for k in np.asarray(keys).astype(np.uint64):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int((k[0] << np.uint64(32)) | k[1]) % (1 << 63))
            draws.append(self.ref.poisson_sample(self.drawn, gen,
                                                 self.dtype))
        cap = max(1, max(int(d.numel()) for d in draws))
        B = len(draws)
        pos = torch.zeros((B, cap), dtype=torch.int64, device=self.device)
        cols = {}
        for b, d in enumerate(draws):
            pos[b, :d.numel()] = d
            for v, col in self._rows(d).items():
                if v not in cols:
                    cols[v] = torch.zeros((B, cap), dtype=col.dtype,
                                          device=self.device)
                cols[v][b, :d.numel()] = col
        count = torch.tensor([d.numel() for d in draws], device=self.device)
        return SimpleNamespace(positions=pos, count=count, columns=cols,
                               overflow=torch.zeros(B, dtype=torch.bool))

    def full_join(self, query):
        import torch

        return self._rows(torch.arange(self.star.size, device=self.device))

    def apply_delta(self, delta):
        spec = {rel: {"delete": d.delete_mask, "insert": d.inserts}
                for rel, d in delta.relations.items()}
        self.tables = self.ref.apply_delta(self.tables, spec)
        self.db.version += 1
        self._star()
        return self


def control_engine(dtype: str, fault=None):
    """``run_cell``'s ``engine_factory``: the reference engine in
    ``dtype`` over the benchmark's own tables, with ``fault`` planted."""
    from portbench.lib import manifest

    def maker(tables, config, device):
        ref = manifest.load_module(manifest.HERE / "reference"
                                   / f"{config['reference']}.py")
        return lambda db: ReferenceEngine(ref, tables, config, dtype, device,
                                          fault)
    return maker


def main(argv=None) -> int:
    import torch

    from portbench.lib import manifest
    from portbench.lib.bench import run_cell

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--dtype", default=None)
    ap.add_argument("--fault", choices=("mean_p", "next_p"), default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="row counts' multiplier (the CPU tests' small "
                    "sizes); the control's readings are at 1")
    args = ap.parse_args(argv)
    man = manifest.load()
    config = manifest.resolve(man, args.workload)["config"]
    precision = config["guarantees"]["draw_precision"]
    dtype = args.dtype or (precision if args.fault else BELOW[precision])
    device = torch.device(args.device)
    for seed in args.seeds:
        out = run_cell(args.workload, seed, args.seconds, False, device,
                       time.perf_counter(), scale=args.scale,
                       engine_factory=control_engine(dtype, args.fault))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": dtype, "fault": args.fault,
                          "correct": out["correct"],
                          "attempted": out["attempted"],
                          "checks": out["checks"],
                          "checked": out["checked"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
