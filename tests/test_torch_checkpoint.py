"""The port's checkpoint manager (``repro_torch.checkpoint``) on the CPU:

  * save and restore give back every leaf exactly, with its dtype (bf16
    by its 16-bit pattern, numpy arrays and Python numbers included) and
    device, under the reference's ``/``-joined key paths;
  * keep-N removes all but the newest checkpoints; a crashed save's
    ``tmp.*`` directory is not a step;
  * a torn shard fails its digest, and restore falls back to the previous
    step;
  * a writer's error surfaces at the next ``wait`` (and ``save``), once;
  * the asynchronous snapshot is a copy: an in-place update made right
    after ``save`` does not reach the checkpoint.
"""
import json
import threading

import numpy as np
import pytest
import torch

from repro.checkpoint import manager as r_manager
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as t_manager


def tree(seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"blocks.0.attn.wq": torch.randn(4, 6, generator=g),
                   "embed": torch.randn(9, 4, generator=g).to(torch.bfloat16),
                   "final_norm.scale": torch.randn(4, generator=g)},
        "opt": {"step": torch.tensor(7, dtype=torch.int32),
                "m": {"embed": torch.randn(9, 4, generator=g)},
                "v": {"embed": {"vr": torch.randn(9, generator=g),
                                "vc": torch.randn(4, generator=g)}}},
        "data_version": np.asarray(3, np.int64),
        "count": 5,
    }


def zeros_like_tree(t):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out[k] = zeros_like_tree(v)
        elif isinstance(v, torch.Tensor):
            out[k] = torch.zeros_like(v)
        elif isinstance(v, np.ndarray):
            out[k] = np.zeros_like(v)
        else:
            out[k] = type(v)(0)
    return out


def assert_tree_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, dict):
            assert_tree_equal(g, w)
        elif isinstance(w, torch.Tensor):
            assert isinstance(g, torch.Tensor) and g.dtype == w.dtype, k
            assert g.device == w.device and torch.equal(g, w), k
            if w.dtype == torch.bfloat16:  # the same bits
                assert torch.equal(g.view(torch.int16), w.view(torch.int16))
        elif isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w)
        else:
            assert type(g) is type(w) and g == w, k


@pytest.mark.parametrize("async_save", [True, False])
def test_save_restore_exact(tmp_path, async_save):
    want = tree()
    m = CheckpointManager(tmp_path, async_save=async_save)
    m.save(10, want)
    m.wait()
    step, got = m.restore(zeros_like_tree(want))
    assert step == 10
    assert_tree_equal(got, want)
    d = tmp_path / "step_0000000010"
    assert sorted(p.name for p in d.iterdir()) == ["manifest0.json",
                                                   "shard0.npz"]
    man = json.loads((d / "manifest0.json").read_text())
    assert man["step"] == 10 and man["process"] == 0
    assert man["dtypes"]["params/embed"] == "bfloat16"
    with np.load(d / "shard0.npz") as z:
        assert z["params/embed"].dtype == np.uint16


def test_key_paths_are_the_references():
    want = tree()
    host = {k: (v.float().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in t_manager.flatten(want).items()}
    nested = {}
    for k, v in host.items():  # the same tree in numpy, for the reference
        *path, leaf = k.split("/")
        node = nested
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v)
    assert sorted(r_manager._flatten(nested)) == sorted(host)
    assert list(t_manager.flatten(want)) == list(host)


def test_restore_into_the_templates_dtype_and_explicit_step(tmp_path):
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(1, {"w": torch.arange(6, dtype=torch.float32)})
    m.save(2, {"w": torch.arange(6, dtype=torch.float32) + 1})
    step, got = m.restore({"w": torch.zeros(6, dtype=torch.float64)}, step=1)
    assert step == 1 and got["w"].dtype == torch.float64
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float64))
    empty = CheckpointManager(tmp_path / "none")
    tpl = {"w": torch.zeros(2)}
    assert empty.restore(tpl) == (None, tpl)


def test_keep_n_and_crashed_tmp(tmp_path):
    m = CheckpointManager(tmp_path, keep_n=2)
    for s in range(1, 6):
        m.save(s, {"w": torch.full((3,), float(s))})
    m.wait()
    assert m.all_steps() == [4, 5]
    (tmp_path / "tmp.6.0").mkdir()  # a save that crashed before its rename
    assert m.all_steps() == [4, 5]
    step, got = m.restore({"w": torch.zeros(3)})
    assert step == 5 and torch.equal(got["w"], torch.full((3,), 5.0))


def test_torn_shard_falls_back(tmp_path, capsys):
    m = CheckpointManager(tmp_path, async_save=False)
    m.save(10, {"w": torch.full((4,), 1.0)})
    m.save(20, {"w": torch.full((4,), 2.0)})
    shard = tmp_path / "step_0000000020" / "shard0.npz"
    data = bytearray(shard.read_bytes())
    data[len(data) // 2] ^= 0xFF  # one flipped byte: the digest fails
    shard.write_bytes(bytes(data))
    step, got = m.restore({"w": torch.zeros(4)})
    assert step == 10 and torch.equal(got["w"], torch.full((4,), 1.0))
    assert "step 20 failed integrity check" in capsys.readouterr().out
    (tmp_path / "step_0000000010" / "manifest0.json").unlink()
    tpl = {"w": torch.zeros(4)}
    assert m.restore(tpl) == (None, tpl)


def test_writer_error_surfaces_at_the_next_wait(tmp_path):
    m = CheckpointManager(tmp_path)
    (tmp_path / "tmp.3.0").write_text("not a directory")  # rmtree fails
    m.save(3, {"w": torch.ones(2)})  # returns: the writer fails later
    with pytest.raises(NotADirectoryError):
        m.wait()
    m.wait()  # raised once
    (tmp_path / "tmp.3.0").unlink()
    m.save(3, {"w": torch.ones(2)})
    (tmp_path / "tmp.4.0").write_text("not a directory")
    m.save(4, {"w": torch.ones(2)})
    with pytest.raises(NotADirectoryError):
        m.save(5, {"w": torch.ones(2)})  # the previous save's error
    assert m.all_steps() == [3]


def test_async_snapshot_is_a_copy(tmp_path, monkeypatch):
    """The writer holds until the caller has changed the tensor in place:
    the checkpoint keeps the values of the moment of ``save``."""
    updated = threading.Event()
    write = CheckpointManager._write

    def held_write(self, step, host):
        assert updated.wait(10)
        write(self, step, host)

    monkeypatch.setattr(CheckpointManager, "_write", held_write)
    m = CheckpointManager(tmp_path)
    w = torch.arange(8, dtype=torch.float32)
    b = torch.ones(3, dtype=torch.bfloat16)
    m.save(1, {"w": w, "b": b})
    with torch.no_grad():
        w.add_(100.0)
        b.mul_(3)
    updated.set()
    m.wait()
    _, got = m.restore({"w": torch.zeros(8), "b": torch.zeros(3,
                                                           dtype=torch.bfloat16)})
    assert torch.equal(got["w"], torch.arange(8, dtype=torch.float32))
    assert torch.equal(got["b"], torch.ones(3, dtype=torch.bfloat16))
