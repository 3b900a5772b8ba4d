"""Device meshes for the sharded engine path: one process drives them all.

A ``Mesh`` names the axes of a grid of ``torch.device`` entries, as the
reference's ``jax.sharding.Mesh`` names a grid of devices for
``shard_map``. The port is single-controller too: one process, one
engine, and each shard's draw launched on its entry's device from one
host thread. An entry may repeat, so a mesh of four entries on one card
runs four real shards on it: the port's counterpart of the reference's
``force_host_devices(4)``.

``make_production_mesh`` gives the reference's production meshes (one pod
of 16 x 16, or two) with every entry on the ``meta`` device: on one host
they are shape arithmetic for the dry run (``launch/dryrun.py``), not
devices to run on. ``device_mesh`` gives such a mesh's
``torch.distributed`` counterpart, a ``DeviceMesh`` over a process group of
the ``fake`` backend (no process but this one, no communication), on
which the dry run counts a step's collectives (``launch/comm_cost.py``).
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "make_host_mesh", "make_production_mesh",
           "device_mesh", "batch_axes"]

Devices = Union[None, str, torch.device, Sequence[Union[str, torch.device]]]


def _checked(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index, raising when it
    names a card that is not there."""
    dev = torch.device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        index = torch.cuda.current_device() if dev.index is None and count \
            else dev.index
        if index is None or not 0 <= index < count:
            raise RuntimeError(f"mesh entry {dev} names no visible card "
                               f"({count} visible)")
        dev = torch.device("cuda", index)
    return dev


class Mesh:
    """Named axes over a grid of devices: ``devices`` is an object array
    of ``torch.device`` whose shape is the axes' sizes. ``shape`` maps each
    axis to its size in axis order, as the reference's ``Mesh.shape``."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        axis_names = tuple(axis_names)
        if devices.ndim != len(axis_names) or len(set(axis_names)) != \
                len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} needs "
                             f"{devices.ndim} distinct axis names, got "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = axis_names

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def shard_coords(self, axes: Sequence[str]) -> List[Tuple[int, ...]]:
        """The coordinates over ``axes`` of each shard, in the order of its
        linear index (the reference's ``P(axes)`` block layout: the first
        axis most significant)."""
        return list(itertools.product(*(range(self.shape[a]) for a in axes)))

    def shard_devices(self, axes: Sequence[str]) -> List[torch.device]:
        """The device of each shard over ``axes``: the entry at the shard's
        coordinates, and at index 0 of every other axis (where the
        reference replicates the shard)."""
        out = []
        for coords in self.shard_coords(axes):
            at = dict(zip(axes, coords))
            out.append(self.devices[tuple(at.get(a, 0)
                                          for a in self.axis_names)])
        return out

    def __repr__(self) -> str:
        devices = sorted({str(d) for d in self.devices.flat})
        return f"Mesh({self.shape}, {devices})"


def _entries(n: int, devices: Devices) -> List[torch.device]:
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("make_mesh places entries on the cards by "
                               "default and none is visible; pass "
                               "devices='cpu' to build a mesh on the CPU")
        return [torch.device("cuda", i % count) for i in range(n)]
    if isinstance(devices, (str, torch.device)):
        return [_checked(devices)] * n
    entries = [_checked(d) for d in devices]
    if len(entries) != n:
        raise ValueError(f"{len(entries)} devices for a mesh of {n} entries")
    return entries


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              devices: Devices = None) -> Mesh:
    """A mesh of ``prod(shape)`` entries named ``axes``: round-robin over
    the visible cards (``devices=None``), every entry on one device (a
    device or its name, e.g. ``'cpu'``), or the given entries in row-major
    order. An entry that names a missing card raises."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 1
    grid = np.empty((n,), dtype=object)
    for i, d in enumerate(_entries(n, devices)):
        grid[i] = d
    return Mesh(grid.reshape(shape), axes)


def make_host_mesh(model: int = 1, devices: Devices = None) -> Mesh:
    """Whatever devices exist, data-parallel: a ("data", "model") mesh of
    shape (n // model, model) over every visible card (``devices=None``),
    one entry of one named device, or the given entries."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = max(n, 1)  # no card: _entries raises
    elif isinstance(devices, (str, torch.device)):
        n = 1
    else:
        n = len(devices)
    if n % model:
        raise ValueError(f"{n} entries do not split into model={model}")
    return make_mesh((n // model, model), ("data", "model"), devices)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) = ("data", "model"), one pod of 256 chips, or (2, 16, 16) =
    ("pod", "data", "model"), two pods of 512: every entry on ``meta``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices="meta")


@contextlib.contextmanager
def device_mesh(mesh: Mesh, rank: int = 0):
    """A ``torch.distributed.device_mesh.DeviceMesh`` of ``mesh``'s shape
    and axis names, as this process's ``rank`` (default 0) of a process
    group of the ``fake`` backend with world size ``mesh.size`` and a
    ``HashStore``: collectives on its DTensors are issued (and counted) but
    move nothing, and every entry is shape arithmetic, as
    ``make_production_mesh``'s ``meta`` entries are. The group lives in
    this process for the ``with`` block only and is taken down after it,
    so that one count does not meet another's (tests under xdist, the dry
    run's workers). Raises if a group already exists."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if dist.is_initialized():
        raise RuntimeError("device_mesh: a process group already exists in "
                           "this process")
    _register_fake_backend()
    dist.init_process_group("fake", store=dist.HashStore(), rank=rank,
                            world_size=mesh.size)
    try:
        yield init_device_mesh("cpu", tuple(mesh.devices.shape),
                               mesh_dim_names=mesh.axis_names)
    finally:
        dist.destroy_process_group()


def _register_fake_backend() -> None:
    """Registers torch's ``fake`` process-group backend. On purpose this
    imports a module of ``torch.testing._internal``, which has no
    compatibility promise: the backend is registered by that import, and
    by nothing public (``init_process_group`` makes the same import itself
    when it is given no store, in the versions that do). If the module
    moves, this raises saying so (``tests/test_torch_dryrun_collectives.py``
    ``test_device_mesh_on_the_fake_backend`` holds it)."""
    try:
        import torch.testing._internal.distributed.fake_pg  # noqa: F401
    except ImportError as e:
        import torch

        raise RuntimeError(
            f"device_mesh: torch {torch.__version__} has no "
            "torch.testing._internal.distributed.fake_pg, whose import "
            "registers the 'fake' process-group backend that the dry run "
            "counts collectives on") from e


def batch_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes present in this mesh ((pod,)data)."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)
