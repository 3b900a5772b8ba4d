"""The reference's oracles under their own names (``repro.kernels.ref``):
each is the plain PyTorch version of its kernel, the ground truth the
kernels are held against. ``ops.ref`` is this module, as in the
reference."""
from __future__ import annotations

from .bsearch_probe import bsearch_probe_plain as bsearch_probe_ref
from .flash_decode import flash_decode_plain as flash_decode_ref
from .flash_prefill import flash_prefill_plain as flash_prefill_ref
from .geo_gaps import geo_gaps_plain as geo_gaps_ref
from .prefix_sum import prefix_sum_plain as prefix_sum_ref

__all__ = ["bsearch_probe_ref", "prefix_sum_ref", "geo_gaps_ref",
           "flash_decode_ref", "flash_prefill_ref"]

