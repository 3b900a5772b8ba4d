"""Kernel policy and device resolution for the PyTorch/CUDA port.

``KernelPolicy`` is the one value object that decides which kernels run.
It has no environment reads: a caller builds one and passes it (to
``build_shred``, ``QueryEngine``, the probe routes), and the default is
``KernelPolicy()``.

The port keeps three budgets of its own, all in int32 elements:

  * ``arena_limit`` — the largest index arena ``pack_index`` packs as one
    buffer, and the largest page the paged GET takes. The arena lives in
    device memory and is read through L2, so the only real limit is that
    every offset into it fits int32.
  * ``draw_limit`` — the largest arena the one-launch fused draw takes,
    and the largest page the paged draw takes. It defaults to the
    reference's own VMEM budget (2^21), so draws route exactly as the
    reference routes them: the float32 draw loses cell resolution as the
    arrival mass grows, and this budget keeps it where the reference
    keeps it.
  * ``paged_limit`` — the largest arena the paged rung takes (the
    reference's ``PAGED_PACK_LIMIT``, 2^25).

Kernel tiles resolve through ``kernels/autotune.tile_for``: a pin in
``tile_overrides``, then the committed ``kernels/TUNE_TABLE.json`` under
``backend_key()`` (then its ``default`` entry), then the kernel's builtin
default; ``tuned=False`` skips the table.

The ladders, as in the reference: an arena within ``arena_limit`` packs
as one buffer; over it, ``pack_index`` pages it when every page fits
``arena_limit`` and the whole fits ``paged_limit``. The draw is ``fused``
when the packed arena fits ``draw_limit``, else ``paged`` when every page
fits ``draw_limit`` and the whole fits ``paged_limit``, else ``pernode``.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["KernelPolicy", "DEFAULT_POLICY", "ARENA_LIMIT", "DRAW_LIMIT",
           "PAGED_LIMIT", "resolve_device", "device_name", "backend_key"]

# Every arena offset and every probe position must fit int32.
ARENA_LIMIT = (1 << 31) - 1
# The reference's fused-draw budget (its DEFAULT_VMEM_LIMIT).
DRAW_LIMIT = 1 << 21
# The reference's ceiling on a paged arena (its PAGED_PACK_LIMIT).
PAGED_LIMIT = 1 << 25


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """How the port selects its kernels.

    enabled      master switch: False routes every wrapper through its
                 library fallback (``torch.searchsorted``) and the per-node
                 GET, and disables the fused draw.
    prefer       take the kernel routes on CPU tensors too, where the
                 wrappers run their plain versions (tests pin the routes
                 with it). On CUDA tensors the kernel routes are taken
                 whenever ``enabled``.
    arena_limit  int32 elements: the largest arena ``pack_index`` packs,
                 and the largest page of the paged GET.
    draw_limit   int32 elements: the largest arena the fused draw takes,
                 and the largest page of the paged draw.
    paged_limit  int32 elements: the largest arena the paged rung takes.
    fused_draw   allow the kernel draws (fused, then paged) in
                 ``kernels='auto'``.
    tuned        resolve kernel tiles through the committed
                 ``kernels/TUNE_TABLE.json`` (per card and problem-size
                 bucket); False pins every kernel's builtin default tile.
    tile_overrides
                 per-kernel tile pins that win over the table: a tuple of
                 ``(kernel_name, value)`` pairs (a tuple, not a dict, so
                 the policy stays hashable), e.g. ``(("tree_probe", 16),
                 ("flash_prefill", (64, 128)))``.
    """

    enabled: bool = True
    prefer: bool = False
    arena_limit: int = ARENA_LIMIT
    draw_limit: int = DRAW_LIMIT
    paged_limit: int = PAGED_LIMIT
    fused_draw: bool = True
    tuned: bool = True
    tile_overrides: tuple = ()

    def preferred(self, device) -> bool:
        """Should hot paths take the kernel routes for tensors on
        ``device``? Always on CUDA (when enabled); on the CPU only when
        ``prefer`` pins it."""
        kind = torch.device(device).type
        return self.enabled and (self.prefer or kind == "cuda")

    def tile_override(self, kernel: str):
        """The pinned tile for ``kernel`` from ``tile_overrides``, or
        ``None``: the first rung of ``kernels/autotune.tile_for``."""
        for name, value in self.tile_overrides:
            if name == kernel:
                return value
        return None


DEFAULT_POLICY = KernelPolicy()


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when CUDA is asked for (or
    defaulted to) and absent: entry points never fall back to the CPU;
    only an explicit ``device='cpu'`` runs there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions")
    return dev


def device_name(device=None) -> str:
    """The device's name: the card's product name, or 'cpu'."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return "cpu"


def backend_key(device=None) -> str:
    """The tuning table's entry key for ``device`` (the current card when
    ``None`` and one is present, else the CPU): ``'cuda/<product name>'``,
    e.g. ``'cuda/NVIDIA H100 80GB HBM3'``, or ``'cpu/cpu'`` (the
    reference's key for its CPU backend)."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda/{torch.cuda.get_device_name(dev)}"
    return f"{dev.type}/{dev.type}"
