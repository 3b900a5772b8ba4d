"""Checkpoint manager: the restart half of fault tolerance
(``repro.checkpoint.manager``).

Guarantees, as the reference's:
  * atomicity — writes go to ``<dir>/tmp.<step>.<pid>/`` and are renamed
    into ``step_%010d`` only after the manifest (with the shard's sha256)
    is fsynced; a crash mid-save never corrupts the latest checkpoint;
  * integrity — restore verifies the digest and falls back to the previous
    step on a mismatch (torn disk, partial copy);
  * bounded disk — all but the newest ``keep_n`` checkpoints are removed
    after a successful save;
  * async — ``save`` snapshots the tree to host memory and hands it to a
    writer thread; one save is outstanding at a time, and its error
    surfaces at the next ``save`` or ``wait``.

The port is single-controller: one process drives every device, so it is
process 0 and writes ``shard0.npz`` and ``manifest0.json``.

Storage is ``np.savez`` of the flattened tree: a nested dict whose leaves
are tensors, numpy arrays or Python numbers, keyed by the ``/``-joined
path of dict keys. numpy has no bfloat16 (and the card's machine has no
``ml_dtypes``), so a bf16 leaf is stored as its 16-bit pattern (uint16)
and the manifest names its dtype; restore gives back the same bits.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointManager", "flatten", "unflatten"]

PROCESS = 0  # the single controller


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """``{"a/b": leaf}`` for every leaf of a nested dict, in its order."""
    flat = {}
    for key, node in tree.items():
        path = f"{prefix}{key}"
        if isinstance(node, dict):
            flat.update(flatten(node, path + "/"))
        else:
            flat[path] = node
    return flat


def unflatten(template, flat: Dict[str, Any], prefix: str = ""):
    """The template's structure with each leaf taken from ``flat``:
    tensors in the template leaf's dtype and on its device, numpy arrays
    in its dtype, Python numbers as its type."""
    out = {}
    for key, node in template.items():
        path = f"{prefix}{key}"
        if isinstance(node, dict):
            out[key] = unflatten(node, flat, path + "/")
            continue
        value = flat[path]
        if isinstance(node, torch.Tensor):
            out[key] = value.to(device=node.device, dtype=node.dtype)
        elif isinstance(node, (np.ndarray, np.generic)):
            out[key] = value.numpy().astype(node.dtype)
        else:
            out[key] = type(node)(value.item())
    return out


def _snapshot(leaf) -> torch.Tensor:
    """A host copy of ``leaf`` that nothing else holds: ``Tensor.cpu()`` of
    a CPU tensor is the same storage, which the optimizer then changes in
    place while the writer thread saves it."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(leaf))


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).replace("torch.", "")


def _from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3,
                 async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, tree: Any, block: bool = False):
        self.wait()  # one outstanding save at a time; surfaces prior errors
        # snapshot before training continues
        host = {k: _snapshot(v) for k, v in flatten(tree).items()}

        def work():
            try:
                self._write(step, host)
            except BaseException as e:  # noqa: BLE001
                self._error = e

        if self.async_save and not block:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            if self._error:
                err, self._error = self._error, None
                raise err

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            err, self._error = self._error, None
            raise err

    def _write(self, step: int, host: Dict[str, torch.Tensor]):
        tmp = self.dir / f"tmp.{step}.{PROCESS}"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        arrays, dtypes = {}, {}
        for key, t in host.items():
            arrays[key], dtypes[key] = _to_numpy(t)
        shard_file = tmp / f"shard{PROCESS}.npz"
        np.savez(shard_file, **arrays)
        manifest = {
            "step": step,
            "time": time.time(),
            "process": PROCESS,
            "files": {shard_file.name: _sha256(shard_file)},
            "keys": sorted(arrays),
            "dtypes": dtypes,
        }
        mpath = tmp / f"manifest{PROCESS}.json"
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final.mkdir(exist_ok=True)
        for item in tmp.iterdir():
            os.replace(item, final / item.name)  # atomic within a filesystem
        shutil.rmtree(tmp, ignore_errors=True)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(len(steps) - self.keep_n, 0)]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def _manifest(self, step: int) -> Optional[dict]:
        """The step's manifest if every file it names matches its digest."""
        d = self.dir / f"step_{step:010d}"
        mpath = d / f"manifest{PROCESS}.json"
        if not mpath.exists():
            return None
        manifest = json.loads(mpath.read_text())
        for fname, digest in manifest["files"].items():
            f = d / fname
            if not f.exists() or _sha256(f) != digest:
                return None
        return manifest

    def restore(self, template: Any, step: Optional[int] = None
                ) -> Tuple[Optional[int], Any]:
        """Restore the given (or latest valid) step into ``template``'s
        structure, dtypes and devices; ``(None, template)`` if none.
        Corrupt checkpoints are skipped with a message — the crash-recovery
        path."""
        steps = [step] if step is not None else list(reversed(self.all_steps()))
        for s in steps:
            manifest = self._manifest(s)
            if manifest is None:
                print(f"[checkpoint] step {s} failed integrity check; skipping")
                continue
            d = self.dir / f"step_{s:010d}"
            with np.load(d / f"shard{PROCESS}.npz") as z:
                flat = {k: _from_numpy(z[k], manifest["dtypes"][k])
                        for k in z.files}
            return s, unflatten(template, flat)
        return None, template
