"""End-to-end training on an engine-native, *live* Poisson-join corpus:
the port of the reference's ``examples/train_lm_joinsampled.py``.

An LM trains on batches drawn by Poisson sampling over a joined corpus
(quality-weighted data selection), while the corpus itself moves mid-run:
a scheduled ``DeltaBatch`` inserts and retires documents at a step-aligned
version barrier through ``engine.apply_delta``.

Run as an integration test (the default), it checks the determinism
contract:

  1. run A trains ``--steps`` straight through, with a corpus delta at
     ``--delta-step``;
  2. run B trains the same config but is "killed" after ``--kill-at``
     steps, then restarted: resume replays the delta schedule from the
     base snapshot, and the checkpoint's recorded ``data_version`` is
     verified against it. With ``--restart`` each leg of run B is a
     process of its own, so the resume is a real restart;
  3. losses AND sampled doc ids of the resumed run must be bit-identical
     to run A's, and the per-step ``db_version`` trace must flip exactly at
     the barrier.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_joinsampled \\
        --device cpu

On the card (the default device) it trains the reduced config too (the
float32 prefill kernel's D 16 instance), and ``--full`` trains
smollm-135m at its published widths. Plain training (no kill/resume
verification):

    PYTHONPATH=src python -m repro_torch.examples.train_lm_joinsampled \\
        --train-only --steps 300 --full
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch import configs
from repro_torch.data import corpus_delta, make_corpus_db
from repro_torch.launch.train import CUBLAS_WORKSPACE, TrainConfig, train

__all__ = ["delta_schedule", "run_integration", "check_contract", "main"]


def delta_schedule(tc: TrainConfig, delta_step: int):
    """The live-corpus event: built against the *same* deterministic base
    snapshot ``train()`` constructs, so a restarted process re-derives the
    identical schedule from the config alone."""
    cfg = configs.get_config(tc.arch)
    if tc.reduced:
        cfg = configs.reduced(cfg)
    db = make_corpus_db(n_docs=512, n_clusters=16, seq_len=tc.seq_len + 1,
                        vocab=cfg.vocab, seed=tc.seed, device=tc.device)
    delta = corpus_delta(db, tc.seq_len + 1, cfg.vocab,
                         insert=64, retire=range(8), seed=tc.seed + 1)
    return ((delta_step, delta),)


def _leg_argv(tc: TrainConfig, delta_step: int, out: Path) -> list:
    argv = ["--leg", str(out), "--steps", str(tc.steps), "--kill-at",
            str(tc.ckpt_every), "--delta-step", str(delta_step), "--batch",
            str(tc.batch), "--seq-len", str(tc.seq_len), "--ckpt-dir",
            tc.ckpt_dir]
    if not tc.reduced:
        argv.append("--full")
    if tc.device is not None:
        argv += ["--device", str(tc.device)]
    return argv


def _in_child(tc: TrainConfig, delta_step: int) -> Dict:
    """``train(tc)`` with ``tc``'s delta schedule in a process of its own
    (``--leg``): its losses, doc ids and versions, read back exactly."""
    out = Path(tc.ckpt_dir) / f"leg_{tc.steps}.json"
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = os.pathsep.join(
        [src] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    subprocess.run([sys.executable, "-m",
                    "repro_torch.examples.train_lm_joinsampled",
                    *_leg_argv(tc, delta_step, out)], env=env, check=True)
    got = json.loads(out.read_text())
    got["doc_ids"] = [np.asarray(d) for d in got["doc_ids"]]
    return got


def _run_leg(tc: TrainConfig, delta_step: int, out: Path) -> None:
    res = train(dataclasses.replace(tc, deltas=delta_schedule(tc, delta_step)))
    # floats through JSON round-trip exactly (shortest repr)
    out.write_text(json.dumps({
        "losses": res["losses"], "data_versions": res["data_versions"],
        "doc_ids": [d.tolist() for d in res["doc_ids"]]}))


def check_contract(a: Dict, b: Dict, steps: int, kill_at: int,
                   delta_step: int) -> None:
    """The determinism contract of a run A and a resumed run B."""
    assert a["data_versions"] == [0] * delta_step + [1] * (steps - delta_step), \
        f"version trace must flip exactly at the barrier: {a['data_versions']}"
    assert b["data_versions"] == a["data_versions"][kill_at:], \
        "resumed run must replay the same version trace"
    tail = a["losses"][kill_at:]
    if not np.array_equal(np.asarray(tail), np.asarray(b["losses"])):
        raise AssertionError(
            f"resumed losses are not bit-identical: {tail} vs {b['losses']}")
    assert len(b["doc_ids"]) == steps - kill_at
    for i, (da, db_) in enumerate(zip(a["doc_ids"][kill_at:], b["doc_ids"])):
        if not np.array_equal(da, db_):
            raise AssertionError(
                f"sampled doc ids diverge at resumed step {kill_at + i}")


def run_integration(steps: int, kill_at: int, delta_step: int,
                    batch: int, seq_len: int, workdir: Path, *,
                    full: bool = False, device=None, restart: bool = False,
                    hooks: Optional[Dict[str, Callable]] = None) -> Dict:
    """Runs A and B and their contract (``check_contract``); ``restart``
    runs each leg of B in a process of its own; ``hooks`` go to run A.
    Returns ``{"a": run A's result, "b": the resumed leg's}``."""
    base = TrainConfig(arch="smollm_135m", steps=steps, batch=batch,
                       seq_len=seq_len, data="poisson_join", reduced=not full,
                       ckpt_every=kill_at, log_every=1000, device=device)
    workdir = Path(workdir)

    print(f"[integration] run A: {steps} steps, delta at {delta_step}")
    a = train(dataclasses.replace(
        base, deltas=delta_schedule(base, delta_step),
        ckpt_dir=str(workdir / "a")), hooks)

    print(f"[integration] run B: kill after step {kill_at}, then resume"
          + (" in a new process" if restart else ""))
    b_dir = str(workdir / "b")
    legs = (dataclasses.replace(base, steps=kill_at, ckpt_dir=b_dir),
            dataclasses.replace(base, ckpt_dir=b_dir))
    if restart:
        _in_child(legs[0], delta_step)
        b = _in_child(legs[1], delta_step)
    else:
        for leg in legs:
            b = train(dataclasses.replace(
                leg, deltas=delta_schedule(leg, delta_step)))

    check_contract(a, b, steps, kill_at, delta_step)
    print(f"[integration] OK: {steps - kill_at} resumed steps bit-identical "
          f"(losses + doc ids), version barrier at step {delta_step}")
    print(f"loss: {a['losses'][0]:.4f} -> {a['losses'][-1]:.4f}")
    return {"a": a, "b": b}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--kill-at", type=int, default=12)
    ap.add_argument("--delta-step", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--train-only", action="store_true",
                    help="plain training run, no kill/resume verification")
    ap.add_argument("--full", action="store_true",
                    help="train the full smollm-135m (sized for the card)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="where to train (default: the card)")
    ap.add_argument("--restart", action="store_true",
                    help="run each leg of run B in a process of its own")
    ap.add_argument("--leg", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)

    if args.leg:  # one leg of run B, in a process of its own
        _run_leg(TrainConfig(arch="smollm_135m", steps=args.steps,
                             batch=args.batch, seq_len=args.seq_len,
                             data="poisson_join", reduced=not args.full,
                             ckpt_every=args.kill_at, log_every=1000,
                             ckpt_dir=args.ckpt_dir, device=args.device),
                 args.delta_step, Path(args.leg))
        return None

    if not args.train_only:
        workdir = Path(args.ckpt_dir or tempfile.mkdtemp(prefix="joinsampled_"))
        return run_integration(args.steps, args.kill_at, args.delta_step,
                               args.batch, args.seq_len, workdir,
                               full=args.full, device=args.device,
                               restart=args.restart)

    tc = TrainConfig(
        arch="smollm_135m",
        reduced=not args.full,
        steps=args.steps,
        batch=args.batch,
        seq_len=args.seq_len,
        data="poisson_join",
        ckpt_dir=args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                               "repro_joinsampled_ckpt"),
        ckpt_every=100,
        device=args.device,
    )
    out = train(tc)
    first, last = out["losses"][0], out["losses"][-1]
    print(f"\ntrained {args.steps} steps on Poisson-join-sampled batches")
    print(f"loss: {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    print(f"straggler events observed: {len(out['straggler_events'])}")
    assert last < first, "training did not reduce loss"
    return out


if __name__ == "__main__":
    main()
