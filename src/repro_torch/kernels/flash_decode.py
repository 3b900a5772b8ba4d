"""One-token decode attention over a KV cache, with GQA and an additive
bias: ``softmax(q . K^T / sqrt(D) + bias) . V`` in float32, out in q's
dtype. q ``(B, H, D)``, k/v ``(B, KV_H, S, D)``, bias ``(B, S)`` float32;
query head h reads KV head ``h // (H / KV_H)``.

``flash_decode`` launches ``csrc/flash_decode.cu`` for CUDA tensors and runs
``flash_decode_plain`` for CPU tensors; ``launches`` counts its calls that
launch a kernel. Each dtype has its own kernel, and neither stands in for
the other. Both cut the cache into splits, one block per split, KV head
and batch row, with K and V fed through a ``cp.async`` ring and each warp
on its own keys:

  * bf16: ``flash_decode_tc_launch``, both products on the tensor cores
    (G <= ``MAX_GROUP_TC``), ``decode_splits`` splits, then a combine
    kernel merges them: two device operations a call;
  * float32: ``flash_decode_launch``, the CUDA cores (G * D <=
    ``MAX_GROUP_WIDTH``), ``decode_splits_f32`` splits (at least two blocks
    an SM where S allows); the last block of each (batch row, KV head)
    merges the splits in the same launch: one device operation a call.

The tile is ``block_s``, keys a ring stage (``autotune``'s parameter: 64,
128 or 256; ``None`` the builtin 64). bf16 has an instance at each that
fits shared memory at the head dim (three stages: up to 256 keys at D 64,
128 at D 128, 64 at D 256: ``TC_INSTANCES``); float32 one a head dim, stages of 4096 / D
keys, at most 128 (its registers hold a lane's share of a key's row:
``F32_TILE_KEYS``). Head dims: ``HEAD_DIMS[dtype]``; float32 also takes
D 16, the reduced configs' (bf16 at D 16 raises: no config asks for it).
Each launches its largest instance at or below ``block_s``
(``instance``, reported by ``decode_config``); a value that names no
instance raises. The splits stay ``decode_splits``' choice.

The kernels take any S: keys past the end of the cache are left out, so no
padding is needed. The partials (and the float32 kernel's counters, 0
between launches) live in a scratch per (device, stream), grown as
needed, so a call allocates nothing but its output.

``out_of_bounds`` runs the checked build (``build.VARIANTS``
``flash_decode_checked``, ``-DFDT_CHECK_BOUNDS``) once and returns the
accesses that fall outside q, k, v, the bias, the output, the partials and
the counters: a measurement, not counted in ``launches``.

The plain version is the dense oracle. It groups q as ``(B, KV_H, G, D)``
and walks the KV heads, so its float32 temporaries stay one head of the
cache at a time (no ``repeat_interleave`` of the cache).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import build
from .autotune import check_value, count_tile

__all__ = ["HEAD_DIMS", "MAX_GROUP_WIDTH", "MAX_GROUP_TC", "MIN_SPLIT",
           "MIN_SPLIT_F32", "F32_WARPS", "F32_TILE_KEYS", "decode_splits",
           "decode_splits_f32", "split_bounds", "flash_decode_plain",
           "flash_decode", "TC_INSTANCES", "instance", "decode_config",
           "out_of_bounds", "CHECK_RECORDS"]

# each dtype's head dims (its kernel's instances)
HEAD_DIMS = {torch.bfloat16: (64, 128, 256), torch.float32: (16, 64, 128, 256)}
MAX_GROUP_WIDTH = 4096    # float32: 128 * FD_LARGE, the most G * D a warp holds
MAX_GROUP_TC = 16         # bf16: FDT_M, the mma rows that hold a group's heads
MIN_SPLIT = 256           # fewest keys a split keeps (S allowing)
MAX_SPLIT = 2048          # most keys a split takes, so blocks come in many waves
BLOCKS_PER_SM = 4         # blocks a call aims at, per SM
# float32: splits as short as a tile of the kernel's ring at D = 128, so
# that small batches put two blocks on every SM
MIN_SPLIT_F32 = 32
MAX_SPLIT_F32 = 2048
BLOCKS_PER_SM_F32 = 2
# its in-launch merge stages 2^(m - max) and l of every (head, split) of
# a group in shared memory: G * nsplit <= MERGE_WORDS (FD_MERGE_WORDS)
MERGE_WORDS = 8192
# the float32 kernel's warps (FD_WARPS) and keys a ring stage (4096 / D:
# 32 KB of K and V, at most a key a lane of each warp); each warp takes a
# quarter of every stage's keys
F32_WARPS = 4
F32_TILE_KEYS = {D: min(4096 // D, 32 * F32_WARPS)
                 for D in HEAD_DIMS[torch.float32]}
# bf16: keys a stage of the instances at each head dim, the builtin
# FDT_TK first (flash_decode.cu fdt_launch builds one where three stages
# of K, V and the bias fit a block's shared memory); a ring of TC_STAGES
TC_INSTANCES = {64: (64, 128, 256), 128: (64, 128), 256: (64,)}
TC_STAGES = 3


def instance(dtype, D: int, block_s=None) -> int:
    """Keys a stage of the instance that ``dtype``'s kernel launches at
    head dim ``D`` for ``block_s`` (``None`` the builtin 64): the largest
    at or below it (float32: its one instance at D, ``F32_TILE_KEYS[D]``).
    Raises on a value that names no instance."""
    block_s = 64 if block_s is None else check_value("flash_decode", block_s)
    if dtype == torch.float32:
        return F32_TILE_KEYS[D]
    return max(tk for tk in TC_INSTANCES[D] if tk <= block_s)


def decode_config(dtype, D: int, block_s=None) -> dict:
    """The tile ``flash_decode`` launches for ``dtype`` at head dim ``D``
    and ``block_s``: ``{"block_s": keys a stage, "stages": ring depth}``."""
    return {"block_s": instance(dtype, D, block_s), "stages": TC_STAGES}
_VP, _INT = ctypes.c_void_p, ctypes.c_int
# library, entry and C prototype of each dtype's kernel: (q, k, v, bias,
# out, acc, m, l, [counters], B, H, KV_H, S, D, nsplit, scale, stream,
# [keys a stage: bf16])
_ENTRIES = {
    torch.bfloat16: ("flash_decode", "flash_decode_tc_launch",
                     [_VP] * 8 + [_INT] * 6 + [ctypes.c_float, _VP, _INT]),
    torch.float32: ("flash_decode", "flash_decode_launch",
                    [_VP] * 9 + [_INT] * 6 + [ctypes.c_float, _VP])}


def decode_splits(rows: int, S: int, sms: int) -> int:
    """How many splits to cut each of ``rows`` (B * KV_H) caches of S keys
    into, for a card with ``sms`` SMs: enough for ``BLOCKS_PER_SM`` blocks
    an SM (at least two) and splits of at most ``MAX_SPLIT`` keys, but no
    split under ``MIN_SPLIT`` keys while S allows. Split i covers
    ``split_bounds(S, n)[i]``."""
    want = max(-(-BLOCKS_PER_SM * sms // max(rows, 1)), -(-S // MAX_SPLIT))
    return max(1, min(want, S // MIN_SPLIT))


def decode_splits_f32(rows: int, S: int, sms: int, group: int = 1) -> int:
    """``decode_splits`` for the float32 kernel: enough splits for
    ``BLOCKS_PER_SM_F32`` blocks an SM and splits of at most
    ``MAX_SPLIT_F32`` keys, but none under ``MIN_SPLIT_F32`` keys while S
    allows (at phase D's 4 rows of 4,096 keys on 132 SMs: 66 splits of 62
    or 63 keys), and at most ``MERGE_WORDS // group`` for a group of
    ``group`` query heads."""
    want = max(-(-BLOCKS_PER_SM_F32 * sms // max(rows, 1)),
               -(-S // MAX_SPLIT_F32))
    return max(1, min(want, S // MIN_SPLIT_F32, MERGE_WORDS // group))


def split_bounds(S: int, nsplit: int) -> list:
    """[begin, end) of each split, as the kernels compute them: split i
    covers keys [i S / n, (i + 1) S / n)."""
    return [(i * S // nsplit, (i + 1) * S // nsplit) for i in range(nsplit)]


def _shapes(q, k, v, bias):
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, H, D = q.shape
    _, KVH, S, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or KVH == 0 or H % KVH:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} against k "
                         f"{tuple(k.shape)}")
    if bias.shape != (B, S) or bias.dtype != torch.float32:
        raise ValueError(f"flash_decode: bias must be ({B}, {S}) float32, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_decode: q {q.dtype}, k {k.dtype}, v {v.dtype}")
    if not q.device == k.device == v.device == bias.device:
        raise ValueError("flash_decode: operands on different devices")
    return B, H, KVH, S, D


def flash_decode_plain(q, k, v, bias) -> torch.Tensor:
    """The dense decode attention, one KV head at a time."""
    B, H, KVH, S, D = _shapes(q, k, v, bias)
    G = H // KVH
    qf = q.to(torch.float32).reshape(B, KVH, G, D)
    out = torch.empty((B, KVH, G, D), dtype=torch.float32, device=q.device)
    for j in range(KVH):
        logits = (torch.matmul(qf[:, j], k[:, j].to(torch.float32).transpose(1, 2))
                  / D ** 0.5 + bias[:, None, :])
        w = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
        w = w / w.sum(dim=-1, keepdim=True)
        out[:, j] = torch.matmul(w, v[:, j].to(torch.float32))
    return out.reshape(B, H, D).to(q.dtype)


def flash_decode(q, k, v, bias, block_s=None) -> torch.Tensor:
    """q (B, H, D), k/v (B, KV_H, S, D), bias (B, S) float32 additive
    (0 or -1e30: padding and window masks). Returns (B, H, D) in q's
    dtype. ``block_s`` is the tile (``None`` the builtin)."""
    B, H, KVH, S, D = _shapes(q, k, v, bias)
    block_s = 64 if block_s is None else check_value("flash_decode", block_s)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    if q.dtype not in _ENTRIES:
        raise TypeError(f"flash_decode: the kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    nsplit = _splits(q, B, H, KVH, S, D)
    tk = instance(q.dtype, D, block_s)
    out = _launch(q, k, v, bias, nsplit, tk)
    flash_decode.launches += 1
    count_tile(flash_decode, f"{_DTYPE_NAMES[q.dtype]} D{D} block_s={tk}")
    return out


def _splits(q, B: int, H: int, KVH: int, S: int, D: int) -> int:
    """The splits of a launch at these shapes on q's card; raises where
    q.dtype's kernel takes no such shape."""
    G = H // KVH
    fits = G <= MAX_GROUP_TC if q.dtype == torch.bfloat16 else \
        G * D <= MAX_GROUP_WIDTH
    if D not in HEAD_DIMS[q.dtype] or not fits or S < 1:
        raise ValueError(f"flash_decode: the {q.dtype} kernel takes D in "
                         f"{HEAD_DIMS[q.dtype]}, G <= {MAX_GROUP_TC} (bf16) "
                         f"or G * D <= {MAX_GROUP_WIDTH} (float32), and S >= "
                         f"1; got D={D}, G={G}, S={S}")
    if q.dtype == torch.bfloat16:
        return decode_splits(B * KVH, S, _sms(q.device))
    return decode_splits_f32(B * KVH, S, _sms(q.device), G)


flash_decode.launches = 0
flash_decode.tiles = {}
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "float32"}
_SMS: Dict[object, int] = {}


def _sms(device: torch.device) -> int:
    """The SM count of ``device``, asked once a card."""
    n = _SMS.get(device.index)
    if n is None:
        n = _SMS[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


class _Scratch:
    """The partials of one (device, stream): ``parts`` (acc, then m and l)
    and the float32 kernel's ``counters`` (zero when made; the kernel
    leaves them at 0)."""

    def __init__(self, device, floats: int, counters: int):
        self.parts = torch.empty(floats, dtype=torch.float32, device=device)
        self.counters = torch.zeros(counters, dtype=torch.int32,
                                    device=device)


_SCRATCH: Dict[Tuple[object, int], _Scratch] = {}


def _scratch(device, stream: int, floats: int, counters: int) -> _Scratch:
    """The scratch of ``stream`` on ``device``, grown (each part to a power
    of two, never below its size) when a launch needs more."""
    s = _SCRATCH.get((device.index, stream))
    if s is None or s.parts.numel() < floats or \
            s.counters.numel() < counters:
        have = (0, 0) if s is None else (s.parts.numel(), s.counters.numel())
        s = _SCRATCH[(device.index, stream)] = _Scratch(
            device, max(have[0], 1 << (floats - 1).bit_length()),
            max(have[1], 1 << (counters - 1).bit_length()))
    return s


def _launch(q, k, v, bias, nsplit: int, tk: int = 64) -> torch.Tensor:
    """Launch q.dtype's kernel on q's stream, or raise; the partials hold
    ``nsplit`` splits of every head; bf16 stages of ``tk`` keys (float32
    has one instance a head dim)."""
    B, H, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    name, entry, argtypes = _ENTRIES[q.dtype]
    fn = build.entry(name, entry, argtypes)
    vec = build.vector_operand
    q, k, v, bias = vec(q), vec(k), vec(v), vec(bias)
    dev = q.device
    out = torch.empty((B, H, D), dtype=q.dtype, device=dev)
    ml = B * H * nsplit
    with build.on_device(dev):
        stream = build.current_stream(dev)
        s = _scratch(dev, stream, ml * (D + 2), B * KVH)
        part = s.parts.data_ptr()
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), part, part + 4 * ml * D,
                part + 4 * ml * (D + 1))
        tile = ()
        if q.dtype == torch.float32:
            ptrs += (s.counters.data_ptr(),)
        else:
            tile = (tk,)
        err = fn(*ptrs, B, H, KVH, S, D, nsplit, 1.0 / D ** 0.5, stream,
                 *tile)
        if err:
            # a refused launch may leave the counters mid-count
            del _SCRATCH[(dev.index, stream)]
        build.check(err, entry)
    return out


CHECK_RECORDS = 64  # FDT_CHECK_RECORDS: the accesses a checked launch keeps


def out_of_bounds(q, k, v, bias, block_s=None) -> dict:
    """One launch of the checked build on CUDA operands at the tile
    ``block_s`` (``None`` the builtin), with the splits ``flash_decode``
    takes and partials of exactly their size, each access held against q,
    k, v, the bias, the output, the partials (acc, m and l apart) and the
    float32 kernel's counters: ``{"count": ..., "loads": [(source line,
    operand, byte offset, the operand's bytes, access bytes), ...], "out":
    the output}``, the first ``CHECK_RECORDS`` accesses recorded. Not
    counted in ``launches``."""
    B, H, KVH, S, D = _shapes(q, k, v, bias)
    if q.device.type != "cuda" or q.dtype not in _ENTRIES:
        raise ValueError("out_of_bounds: the checked build runs the kernels "
                         "on the card, in float32 or bfloat16")
    block_s = 64 if block_s is None else check_value("flash_decode", block_s)
    nsplit = _splits(q, B, H, KVH, S, D)
    tk = instance(q.dtype, D, block_s)
    lib = "flash_decode_checked"
    q, k, v, bias = (build.vector_operand(t) for t in (q, k, v, bias))
    dev, f32 = q.device, torch.float32
    out = torch.empty((B, H, D), dtype=q.dtype, device=dev)
    ml = B * H * nsplit
    acc = torch.empty(ml * D, dtype=f32, device=dev)
    m, l = (torch.empty(ml, dtype=f32, device=dev) for _ in range(2))
    counters = (torch.zeros(B * KVH, dtype=torch.int32, device=dev)
                if q.dtype == f32 else None)
    _, entry, argtypes = _ENTRIES[q.dtype]
    fn = build.entry(lib, entry, argtypes)

    def launch(stream):
        ptrs = [t.data_ptr() for t in (q, k, v, bias, out, acc, m, l)]
        if counters is not None:
            ptrs.append(counters.data_ptr())
        tile = (tk,) if q.dtype == torch.bfloat16 else ()
        build.check(fn(*ptrs, B, H, KVH, S, D, nsplit, 1.0 / D ** 0.5,
                       stream, *tile), entry)

    found = build.checked_run(
        build.entry(lib, "flash_decode_check_set", [_VP, _VP, _INT]),
        launch, build.entry(lib, "flash_decode_check_get", [_VP, _VP]),
        (("q", q), ("k", k), ("v", v), ("bias", bias), ("out", out),
         ("acc", acc), ("m", m), ("l", l), ("counters", counters)), dev,
        CHECK_RECORDS)
    return dict(found, out=out)
