"""One-token decode attention over a KV cache, with GQA and an additive
bias: ``softmax(q . K^T / sqrt(D) + bias) . V`` in float32, out in q's
dtype. q ``(B, H, D)``, k/v ``(B, KV_H, S, D)``, bias ``(B, S)`` float32;
query head h reads KV head ``h // (H / KV_H)``.

``flash_decode`` launches ``csrc/flash_decode.cu`` for CUDA tensors and runs
``flash_decode_plain`` for CPU tensors; ``launches`` counts its calls that
launch a kernel. Each dtype has its own kernel, and neither stands in for
the other: bf16 runs ``flash_decode_tc_launch`` (both products on the
tensor cores, K/V fed by a ``cp.async`` ring; G <= ``MAX_GROUP_TC``),
float32 ``flash_decode_launch`` (the CUDA cores; G * D <=
``MAX_GROUP_WIDTH``). Both cut the cache into ``decode_splits`` splits, one
block per split, KV head and batch row, then combine the splits. The
kernels take any S: keys past the end of the cache are left out, so no
padding is needed.

The plain version is the dense oracle. It groups q as ``(B, KV_H, G, D)``
and walks the KV heads, so its float32 temporaries stay one head of the
cache at a time (no ``repeat_interleave`` of the cache).
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["HEAD_DIMS", "MAX_GROUP_WIDTH", "MAX_GROUP_TC", "MIN_SPLIT",
           "decode_splits", "split_bounds", "flash_decode_plain",
           "flash_decode"]

HEAD_DIMS = (64, 128, 256)  # the kernels' instances
MAX_GROUP_WIDTH = 4096    # float32: 4 * FD_THREADS * FD_SLOTS, the most G * D a block holds
MAX_GROUP_TC = 16         # bf16: FDT_M, the mma rows that hold a group's heads
MIN_SPLIT = 256           # fewest keys a split keeps (S allowing)
MAX_SPLIT = 2048          # most keys a split takes, so blocks come in many waves
BLOCKS_PER_SM = 4         # blocks a call aims at, per SM
# library and entry of each dtype's kernel
_ENTRIES = {torch.bfloat16: ("flash_decode", "flash_decode_tc_launch"),
            torch.float32: ("flash_decode", "flash_decode_launch")}


def decode_splits(rows: int, S: int, sms: int) -> int:
    """How many splits to cut each of ``rows`` (B * KV_H) caches of S keys
    into, for a card with ``sms`` SMs: enough for ``BLOCKS_PER_SM`` blocks
    an SM (at least two) and splits of at most ``MAX_SPLIT`` keys, but no
    split under ``MIN_SPLIT`` keys while S allows. Split i covers
    ``split_bounds(S, n)[i]``."""
    want = max(-(-BLOCKS_PER_SM * sms // max(rows, 1)), -(-S // MAX_SPLIT))
    return max(1, min(want, S // MIN_SPLIT))


def split_bounds(S: int, nsplit: int) -> list:
    """[begin, end) of each split, as the kernels compute them: split i
    covers keys [i S / n, (i + 1) S / n)."""
    return [(i * S // nsplit, (i + 1) * S // nsplit) for i in range(nsplit)]


def _shapes(q, k, v, bias):
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, H, D = q.shape
    _, KVH, S, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or KVH == 0 or H % KVH:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} against k "
                         f"{tuple(k.shape)}")
    if tuple(bias.shape) != (B, S) or bias.dtype != torch.float32:
        raise ValueError(f"flash_decode: bias must be ({B}, {S}) float32, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_decode: q {q.dtype}, k {k.dtype}, v {v.dtype}")
    if len({t.device for t in (q, k, v, bias)}) != 1:
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


def flash_decode(q, k, v, bias) -> torch.Tensor:
    """q (B, H, D), k/v (B, KV_H, S, D), bias (B, S) float32 additive
    (0 or -1e30: padding and window masks). Returns (B, H, D) in q's
    dtype."""
    B, H, KVH, S, D = _shapes(q, k, v, bias)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, bias)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    if q.dtype not in _ENTRIES:
        raise TypeError(f"flash_decode: the kernels take float32 or bfloat16, "
                        f"got {q.dtype}")
    G = H // KVH
    fits = G <= MAX_GROUP_TC if q.dtype == torch.bfloat16 else \
        G * D <= MAX_GROUP_WIDTH
    if D not in HEAD_DIMS or not fits or S < 1:
        raise ValueError(f"flash_decode: the {q.dtype} kernel takes D in "
                         f"{HEAD_DIMS}, G <= {MAX_GROUP_TC} (bf16) or G * D "
                         f"<= {MAX_GROUP_WIDTH} (float32), and S >= 1; got "
                         f"D={D}, G={G}, S={S}")
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    out = _launch(q, k, v, bias, decode_splits(B * KVH, S, sms))
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def _launch(q, k, v, bias, nsplit: int) -> torch.Tensor:
    """Launch q.dtype's kernel on q's stream, or raise; the partials hold
    ``nsplit`` splits of every head."""
    from . import build

    B, H, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    name, entry = _ENTRIES[q.dtype]
    fn = getattr(build.library(name), entry)
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    q, k, v, bias = (build.vector_operand(t) for t in (q, k, v, bias))
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    ml = B * H * nsplit
    part = torch.empty((ml * (D + 2),), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       bias.data_ptr(), out.data_ptr(), part.data_ptr(),
                       part[ml * D:].data_ptr(), part[ml * (D + 1):].data_ptr(),
                       B, H, KVH, S, D, nsplit, 1.0 / D ** 0.5, stream),
                    entry)
    return out
