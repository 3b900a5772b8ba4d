"""The CSR GET's chain walk over one tree edge (paper Fig. 4 and Fig. 11).

Each probe walks the child's same-key chain from its head ``hd`` while
the row is valid and the offset ``idx`` covers the row's weight, passing
weight-0 rows; it returns the row where it stopped (-1 past the chain, an
int32) and what is left of the offset (int64).

``csr_walk`` walks every probe from its head (the reference's vmapped
``_csr_walk``); ``csr_walk_cached`` resumes each probe from where the
previous probe with the same head stopped while its offset has not fallen
below what that walk consumed (the reference's ``lax.scan``
``_csr_walk_cached``, the paper's caching walk over ascending probes).
Both give the same rows and offsets. For CUDA tensors each launches
``csrc/csr_walk.cu`` (the design is there); for CPU tensors each runs its
plain version: ``csr_walk_plain`` steps every lane at once until none
moves, ``csr_walk_cached_plain`` is the scan as a literal loop, run by
run, for test sizes. Each wrapper's ``launches`` counts its kernel
launches.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import build

__all__ = ["csr_walk_plain", "csr_walk_cached_plain", "csr_walk",
           "csr_walk_cached"]

I32 = torch.int32
I64 = torch.int64


def _check(weight, nxt, hd, idx) -> None:
    for name, t, dtype in (("weight", weight, I64), ("nxt", nxt, I32),
                           ("hd", hd, I32), ("idx", idx, I64)):
        if t.dtype != dtype or t.ndim != 1:
            raise ValueError(f"csr_walk: {name} must be a {dtype} vector, "
                             f"got {t.dtype} of shape {tuple(t.shape)}")
    if weight.shape != nxt.shape or hd.shape != idx.shape:
        raise ValueError("csr_walk: weight and nxt, hd and idx must match")
    if len({t.device for t in (weight, nxt, hd, idx)}) != 1:
        raise ValueError("csr_walk: operands on several devices")


def csr_walk_plain(weight: torch.Tensor, nxt: torch.Tensor, hd: torch.Tensor,
                   idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every lane one link a step, for as long as any lane moves (a host
    read a step); a lane stops where the reference's loop stops."""
    row, rem = hd.clone(), idx.clone()
    while True:
        live = row >= 0
        if not bool(live.any()):
            break
        at = torch.clamp(row, min=0).to(I64)
        w = weight[at]
        go = live & (rem >= w)
        if not bool(go.any()):
            break
        row = torch.where(go, nxt[at], row)
        rem = torch.where(go, rem - w, rem)
    return row, rem


def csr_walk_cached_plain(weight: torch.Tensor, nxt: torch.Tensor,
                          hd: torch.Tensor, idx: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's scan, probe after probe on the host: the carry
    (head, row, consumed) resumes the walk while the head repeats and the
    offset is at least what was consumed. For test sizes only."""
    wl, nl = weight.tolist(), nxt.tolist()
    rows, rems = [], []
    prev_head, prev_row, prev_used = -2, -1, 0
    for h, i in zip(hd.tolist(), idx.tolist()):
        same = prev_head == h and i >= prev_used
        row, used = (prev_row, prev_used) if same else (h, 0)
        rem = i - used
        while row >= 0 and rem >= wl[row]:
            rem -= wl[row]
            used += wl[row]
            row = nl[row]
        rows.append(row)
        rems.append(rem)
        prev_head, prev_row, prev_used = h, row, used
    return (torch.tensor(rows, dtype=I32, device=hd.device),
            torch.tensor(rems, dtype=I64, device=hd.device))


_VP = ctypes.c_void_p


def _launch(weight, nxt, hd, idx, cached: bool):
    fn = build.entry("csr_walk", "csr_walk_launch",
                     [_VP, _VP, _VP, _VP, _VP, _VP, ctypes.c_longlong,
                      ctypes.c_int, _VP])
    weight, nxt = weight.contiguous(), nxt.contiguous()
    hd, idx = hd.contiguous(), idx.contiguous()
    dev = hd.device
    row = torch.empty_like(hd)
    rem = torch.empty_like(idx)
    if hd.numel() == 0:
        return row, rem
    wrapper = csr_walk_cached if cached else csr_walk
    with build.on_device(dev):
        build.check(fn(weight.data_ptr(), nxt.data_ptr(), hd.data_ptr(),
                       idx.data_ptr(), row.data_ptr(), rem.data_ptr(),
                       hd.numel(), int(cached), build.current_stream(dev)),
                    wrapper.__name__)
    wrapper.launches += 1
    return row, rem


def _walk(weight, nxt, hd, idx, cached: bool):
    _check(weight, nxt, hd, idx)
    if hd.device.type == "cpu":
        plain = csr_walk_cached_plain if cached else csr_walk_plain
        return plain(weight, nxt, hd, idx)
    if hd.device.type != "cuda":
        raise ValueError(f"csr_walk: unsupported device {hd.device}")
    return _launch(weight, nxt, hd, idx, cached)


def csr_walk(weight: torch.Tensor, nxt: torch.Tensor, hd: torch.Tensor,
             idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """weight (n,) int64 and nxt (n,) int32: the child's weights and
    chain; hd (m,) int32 heads (-1: an empty run) and idx (m,) int64
    offsets. Returns (row (m,) int32, rem (m,) int64), each probe walked
    from its head."""
    return _walk(weight, nxt, hd, idx, cached=False)


csr_walk.launches = 0


def csr_walk_cached(weight: torch.Tensor, nxt: torch.Tensor,
                    hd: torch.Tensor, idx: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``csr_walk`` with the paper's cache: each probe resumes the walk of
    the previous probe when the head repeats and its offset is at least
    what that walk consumed (ascending probes, as samplers emit them).
    The same result as ``csr_walk``."""
    return _walk(weight, nxt, hd, idx, cached=True)


csr_walk_cached.launches = 0
