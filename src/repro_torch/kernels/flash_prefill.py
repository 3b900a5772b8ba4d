"""Causal or full flash attention over whole sequences, with GQA:
``softmax(q . K^T / sqrt(D), keys j <= i when causal) . V`` in float32,
out in q's dtype. q ``(B, H, S, D)``, k/v ``(B, KV, S, D)``; query head h
reads KV head ``h // (H / KV)``.

``flash_prefill`` launches a kernel for CUDA tensors and runs
``flash_prefill_plain`` for CPU tensors; ``launches`` counts its calls that
launch a kernel. Each dtype has its own kernel, and neither stands in for
the other:

  * bf16: ``csrc/flash_prefill_tc.cu``, on the tensor cores (``wgmma``):
    one block of a TMA producer and a consumer warpgroup per 64 of its
    ``block_q`` query rows, a block per tile, head and batch row; K and V
    stream through a ring of two or three stages;
  * float32: ``csrc/flash_prefill.cu``, on the CUDA cores (D 16, 64,
    128 and 256: ``HEAD_DIMS``; D 16 is the reduced configs'). The reference
    computes in float32, and the tensor cores' TF32 keeps too few digits
    for its tolerances. A persistent grid (one block of four warps an SM)
    takes work items of ``TILE_Q`` query rows, head and batch row from a
    ticket counter in ``work_order``, heaviest first; K and V stream
    through a ``cp.async`` ring; each warp keeps its scores and its online
    softmax in registers (base 2). The counter lives in a scratch per
    (device, stream), which the kernel leaves at 0.

Both run an online softmax over key tiles, so no S x S score matrix
exists, and take any S: keys past the end are left out, causal or not, so
no padding is needed.

The tile is ``(block_q, block_k)``: query rows a block (an item) and keys
a tile (``autotune``'s parameter: (64, 64), (64, 128), (128, 64) or (128,
128); ``None`` the builtin (128, 128)). bf16 has an instance of each
where two stages of K and V fit shared memory (at D 256 keys tiles of 64
only): ``TC_INSTANCES``, the sources' list; float32 keeps ``TILE_Q`` rows an item and has the keys tiles of
``F32_INSTANCES``. Each launches its largest instance at or below the
tile on each axis (``instance``, reported by ``prefill_config``), which
for the builtin is the tile each head dim had before tuning; a value that
names no instance raises.

``out_of_bounds`` runs q.dtype's checked build once (``build.VARIANTS``:
bf16 ``-DFPT_CHECK_BOUNDS``, float32 ``-DFP_CHECK_BOUNDS``) and returns
the accesses that fall outside q, k, v and the output (bf16: the stores,
and it raises if a tensor map does not span its operand's bytes, since TMA
reads nothing outside its map; float32: every ``cp.async`` source, store
and ticket atomic, the ticket a range of its own): a measurement, not
counted in ``launches``.

The plain version is the dense oracle. It walks batch rows and KV heads,
so its float32 scores are one group's ``(G, S, S)`` at a time.

``FlashPrefill`` is ``ops.prefill_attention``'s route: an autograd
function whose forward is ``flash_prefill`` (the same launch and bits,
with or without a graph) and whose backward computes dq, dk and dv with
torch operations in float32 (``flash_prefill_backward``), a block of query
rows at a time, inside the profiler range ``BACKWARD_RANGE``. The
reference has no backward kernel either: ``jax.grad`` differentiates its
attention in XLA.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

from . import build
from .autotune import check_value, count_tile

__all__ = ["HEAD_DIMS", "TILE_Q", "F32_SHAPES", "F32_INSTANCES",
           "TC_INSTANCES", "instance", "prefill_config",
           "work_order",
           "flash_prefill_plain", "flash_prefill", "flash_prefill_backward",
           "FlashPrefill", "BACKWARD_RANGE", "out_of_bounds",
           "CHECK_RECORDS", "MAP_RANGE_ERROR"]

# each dtype's head dims (its kernel's instances): float32 also takes D 16,
# the reduced configs'; no config asks for bf16 at D 16
HEAD_DIMS = {torch.bfloat16: (64, 128, 256), torch.float32: (16, 64, 128, 256)}
TILE_Q = 64  # query rows of a float32 work item (FP_BQ)
# the float32 kernel's FpShape<D>: (row warps, key warps, keys a tile); a
# warp takes TILE_Q / row warps rows and keys a tile / key warps keys
F32_SHAPES = {16: (4, 1, 64), 64: (2, 2, 128), 128: (4, 1, 64),
              256: (4, 1, 32)}
# every float32 instance, FpShape<D, BK>: (D, keys a tile) -> its shape; the
# builtin tile at each D is F32_SHAPES'
F32_INSTANCES = {(64, 128): (2, 2, 128), (64, 64): (4, 1, 64),
                 (128, 64): (4, 1, 64), (256, 32): (4, 1, 32),
                 (16, 64): (4, 1, 64)}
# bf16: (head dim, query rows a block, keys a tile) of each instance ->
# its ring's stages (flash_prefill_tc.cu FptShape: an instance where two
# stages of K and V fit a block's shared memory, three where three fit);
# 64 query rows a consumer warpgroup
TC_INSTANCES = {(D, bq, bk): 3 for D in (64, 128) for bq in (64, 128)
                for bk in (64, 128)}
TC_INSTANCES.update({(256, 64, 64): 3, (256, 128, 64): 2})


def instance(dtype, D: int, block_q=None, block_k=None) -> tuple:
    """(query rows, keys a tile) of the instance that ``dtype``'s kernel
    launches at head dim ``D`` for the tile (``None``s: the builtin (128,
    128)): on each axis the largest at or below it. An explicit value wins
    on its axis; one that names no instance raises."""
    bq, bk = check_value("flash_prefill", (
        128 if block_q is None else block_q,
        128 if block_k is None else block_k))
    if dtype == torch.float32:
        return TILE_Q, max(k for d, k in F32_INSTANCES if d == D and k <= bk)
    bq = max(r for d, r, _ in TC_INSTANCES if d == D and r <= bq)
    return bq, max(k for d, r, k in TC_INSTANCES
                   if d == D and r == bq and k <= bk)


def prefill_config(dtype, D: int, block_q=None, block_k=None) -> dict:
    """The tile ``flash_prefill`` launches for ``dtype`` at head dim ``D``:
    ``{"block_q": ..., "block_k": ..., "stages": ring depth}``."""
    bq, bk = instance(dtype, D, block_q, block_k)
    stages = 2 if dtype == torch.float32 else TC_INSTANCES[(D, bq, bk)]
    return {"block_q": bq, "block_k": bk, "stages": stages}
_MASK = -1e30  # the reference's causal mask value
_VP, _INT = ctypes.c_void_p, ctypes.c_int
# library, entry and C prototype of each dtype's kernel: (q, k, v, out,
# [ticket], B, H, KV, S, D, causal, scale, stream, the tile: bf16 (rows,
# keys), float32 keys)
_ENTRIES = {
    torch.bfloat16: ("flash_prefill_tc", "flash_prefill_tc_launch",
                     [_VP] * 4 + [_INT] * 6 + [ctypes.c_float, _VP, _INT,
                                               _INT]),
    torch.float32: ("flash_prefill", "flash_prefill_launch",
                    [_VP] * 5 + [_INT] * 6 + [ctypes.c_float, _VP, _INT])}


def work_order(S: int, H: int, B: int) -> List[Tuple[int, int, int]]:
    """The float32 kernel's work items (query tile, head, batch row) in the
    order its blocks take them from the ticket: the last query tile first
    (under causal attention it walks the most keys; under full attention
    every tile walks all S), and within a tile batch row by batch row,
    head by head."""
    T = -(-S // TILE_Q)
    return [(T - 1 - n // (H * B), n % (H * B) % H, n % (H * B) // H)
            for n in range(T * H * B)]


def _shapes(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, S, D = q.shape
    KV = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, D) or KV == 0 or H % KV:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)} against k "
                         f"{tuple(k.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_prefill: q {q.dtype}, k {k.dtype}, v {v.dtype}")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("flash_prefill: operands on different devices")
    return B, H, KV, S, D


def flash_prefill_plain(q, k, v, causal: bool = True) -> torch.Tensor:
    """The dense attention, one (batch row, KV head) group at a time."""
    B, H, KV, S, D = _shapes(q, k, v)
    G = H // KV
    out = torch.empty((B, H, S, D), dtype=torch.float32, device=q.device)
    keep = (torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
            if causal else None)
    for b in range(B):
        for j in range(KV):
            heads = slice(j * G, (j + 1) * G)
            s = torch.matmul(q[b, heads].to(torch.float32),
                             k[b, j].to(torch.float32).T) / D ** 0.5
            if causal:
                s = torch.where(keep, s, _MASK)
            out[b, heads] = torch.matmul(torch.softmax(s, dim=-1),
                                         v[b, j].to(torch.float32))
    return out.to(q.dtype)


def flash_prefill(q, k, v, causal: bool = True, block_q=None,
                  block_k=None) -> torch.Tensor:
    """q (B, H, S, D), k/v (B, KV, S, D). Returns (B, H, S, D) in q's
    dtype. ``(block_q, block_k)`` is the tile (``None`` the builtin's on
    that axis)."""
    B, H, KV, S, D = _shapes(q, k, v)
    check_value("flash_prefill", (128 if block_q is None else block_q,
                                  128 if block_k is None else block_k))
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: unsupported device {q.device}")
    if q.dtype not in _ENTRIES:
        raise TypeError(f"flash_prefill: the kernels take float32 or "
                        f"bfloat16, got {q.dtype}")
    if D not in HEAD_DIMS[q.dtype] or S < 1:
        raise ValueError(f"flash_prefill: the {q.dtype} kernel takes D in "
                         f"{HEAD_DIMS[q.dtype]} and S >= 1; got D={D}, S={S}")
    tile = instance(q.dtype, D, block_q, block_k)
    out = _launch(q, k, v, causal, tile)
    flash_prefill.launches += 1
    count_tile(flash_prefill, f"{_DTYPE_NAMES[q.dtype]} D{D} {tile}")
    return out


flash_prefill.launches = 0
flash_prefill.tiles = {}
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "float32"}


# float32 elements of one (B, H, rows, S) block of the backward's scores
BWD_BLOCK_ELEMS = 1 << 26


def flash_prefill_backward(q, k, v, out, d_out, causal: bool = True):
    """dq, dk, dv of ``flash_prefill`` at (q, k, v) with output ``out`` and
    upstream gradient ``d_out``, in float32, back in each operand's dtype.
    Blocks of query rows (``BWD_BLOCK_ELEMS`` scores each) recompute
    ``P = softmax(QK^T / sqrt(D), masked)`` and take ``dV += P^T dO``, ``dP
    = dO V^T``, ``dS = P (dP - rowsum(dO O)) / sqrt(D)``, ``dQ = dS K``,
    ``dK += dS^T Q``; query heads are summed into their KV head."""
    B, H, KV, S, D = _shapes(q, k, v)
    G = H // KV
    f32 = torch.float32
    qg = q.to(f32).reshape(B, KV, G, S, D)
    dog = d_out.to(f32).reshape(B, KV, G, S, D)
    delta = (dog * out.to(f32).reshape(B, KV, G, S, D)).sum(-1)
    kf, vf = k.to(f32)[:, :, None], v.to(f32)[:, :, None]  # (B, KV, 1, S, D)
    dq = torch.empty_like(qg)
    dk = torch.zeros((B, KV, S, D), dtype=f32, device=q.device)
    dv = torch.zeros_like(dk)
    rows = max(1, min(S, BWD_BLOCK_ELEMS // max(B * H * S, 1)))
    for i0 in range(0, S, rows):
        i1 = min(S, i0 + rows)
        t = i1 if causal else S  # keys past the block's last row are masked
        kb, vb = kf[..., :t, :], vf[..., :t, :]
        s = torch.matmul(qg[..., i0:i1, :], kb.transpose(-1, -2)) / D ** 0.5
        if causal:
            keep = (torch.arange(t, device=q.device)[None, :]
                    <= torch.arange(i0, i1, device=q.device)[:, None])
            s = torch.where(keep, s, _MASK)
        p = torch.softmax(s, dim=-1)                      # (B, KV, G, r, t)
        do = dog[..., i0:i1, :]
        dv[..., :t, :] += torch.matmul(p.transpose(-1, -2), do).sum(2)
        ds = p * (torch.matmul(do, vb.transpose(-1, -2))
                  - delta[..., i0:i1, None]) / D ** 0.5
        dq[..., i0:i1, :] = torch.matmul(ds, kb)
        dk[..., :t, :] += torch.matmul(ds.transpose(-1, -2),
                                       qg[..., i0:i1, :]).sum(2)
    return (dq.reshape(B, H, S, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# the ``torch.profiler`` range of FlashPrefill's backward (a training
# step's device time by kind reads it)
BACKWARD_RANGE = "FlashPrefill.backward"


class FlashPrefill(torch.autograd.Function):
    """``flash_prefill`` with a gradient: the forward is the kernel's launch
    (the plain version on the CPU), the backward
    ``flash_prefill_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, block_q=None, block_k=None):
        out = flash_prefill(q, k, v, causal, block_q, block_k)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out = ctx.saved_tensors
        with torch.profiler.record_function(BACKWARD_RANGE):
            dq, dk, dv = flash_prefill_backward(q, k, v, out, d_out,
                                                ctx.causal)
        return dq, dk, dv, None, None, None


CHECK_RECORDS = 64  # FPT_ / FP_CHECK_RECORDS: the accesses a launch keeps
MAP_RANGE_ERROR = 20000  # FPT_ERR_MAP_RANGE: a map that is not its operand
# each dtype's checked build (build.VARIANTS) and its C entries' prefix
_CHECKED = {torch.bfloat16: ("flash_prefill_tc_checked", "flash_prefill_tc"),
            torch.float32: ("flash_prefill_checked", "flash_prefill")}


def out_of_bounds(q, k, v, causal: bool = True, block_q=None,
                  block_k=None) -> dict:
    """One launch of q.dtype's checked build on CUDA operands at the tile
    ``(block_q, block_k)`` (``None`` the builtin's), its accesses held
    against q, k, v and the output (and the float32 kernel's ticket, a
    fresh one): ``{"count": ..., "loads": [(source line, operand, byte
    offset, the operand's bytes, access bytes), ...], "out": the output}``,
    the first ``CHECK_RECORDS`` recorded. bf16 raises if the host finds a
    tensor map whose base and dims are not exactly q's, k's or v's bytes.
    Not counted in ``launches``."""
    B, H, KV, S, D = _shapes(q, k, v)
    if q.device.type != "cuda" or q.dtype not in _CHECKED:
        raise ValueError("out_of_bounds: the checked builds run the kernels "
                         "on the card, in bf16 or float32")
    if D not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"out_of_bounds: the {q.dtype} kernel takes D in "
                         f"{HEAD_DIMS[q.dtype]}; got D={D}")
    tile = instance(q.dtype, D, block_q, block_k)
    lib, prefix = _CHECKED[q.dtype]
    q, k, v = (build.vector_operand(t) for t in (q, k, v))
    out = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    ticket = (torch.zeros(2, dtype=torch.int32, device=q.device)
              if q.dtype == torch.float32 else None)
    _, entry, argtypes = _ENTRIES[q.dtype]
    fn = build.entry(lib, entry, argtypes)

    def launch(stream):
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
        if ticket is not None:
            ptrs.append(ticket.data_ptr())
        err = fn(*ptrs, B, H, KV, S, D, int(bool(causal)), 1.0 / D ** 0.5,
                 stream, *(tile if ticket is None else tile[1:]))
        if err == MAP_RANGE_ERROR and ticket is None:
            raise RuntimeError("out_of_bounds: a tensor map of q, k or v "
                               "does not span its operand's bytes")
        build.check(err, entry)

    found = build.checked_run(
        build.entry(lib, f"{prefix}_check_set", [_VP, _VP, _INT]),
        launch, build.entry(lib, f"{prefix}_check_get", [_VP, _VP]),
        (("q", q), ("k", k), ("v", v), ("out", out), ("ticket", ticket)),
        q.device, CHECK_RECORDS)
    return dict(found, out=out)


# the float32 kernel's ticket per (device index, stream): [next item,
# blocks done], 0 between launches
_TICKETS: Dict[Tuple[object, int], torch.Tensor] = {}


def _launch(q, k, v, causal: bool, tile=None) -> torch.Tensor:
    """Launch q.dtype's kernel on q's stream at ``tile`` (an ``instance``;
    ``None`` the builtin's), or raise."""
    if tile is None:
        tile = instance(q.dtype, q.shape[3])
    B, H, S, D = q.shape
    name, entry, argtypes = _ENTRIES[q.dtype]
    fn = build.entry(name, entry, argtypes)
    q, k, v = (build.vector_operand(t) for t in (q, k, v))
    out = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    dev = q.device
    with build.on_device(dev):
        stream = build.current_stream(dev)
        args = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
        if q.dtype == torch.float32:
            ticket = _TICKETS.get((dev.index, stream))
            if ticket is None:
                ticket = _TICKETS[(dev.index, stream)] = torch.zeros(
                    2, dtype=torch.int32, device=dev)
            args.append(ticket.data_ptr())
        # bf16 takes (rows, keys); float32 its keys (its rows are TILE_Q)
        err = fn(*args, B, H, k.shape[1], S, D, int(bool(causal)),
                 1.0 / D ** 0.5, stream,
                 *(tile if q.dtype == torch.bfloat16 else tile[1:]))
        if err and q.dtype == torch.float32:
            # a refused launch may leave the ticket mid-count
            del _TICKETS[(dev.index, stream)]
        build.check(err, entry)
    return out
