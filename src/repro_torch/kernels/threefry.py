"""Threefry-2x32 counter PRNG: the plain version and the key words.

The fused draw generates its randomness in-kernel (``csrc/threefry.cuh``);
this module is its plain PyTorch version, the same 20-round cipher on
uint32 words held in int64 lanes masked with ``0xFFFFFFFF`` (torch has
little uint32 arithmetic on the CPU). One function serves Python ints,
int64 numpy arrays and int64 tensors alike.

``key(seed)`` gives the (2,) uint32 words that
``jax.random.key_data(jax.random.key(seed))`` gives, so one seed drives
the same fused stream in both packages; ``split(key, num)`` gives the
words of ``jax.random.split(key, num)`` (the partitionable, fold-like
split: key i is the cipher of the 64-bit counter i), and ``keys(seed,
num)`` those of ``split(key(seed), num)``, the canonical keys of a batch,
and ``fold_in(key, data)`` those of ``jax.random.fold_in`` (the cipher
of the counter (0, data)), and ``random_bits(key, n)`` the 32-bit words of
``jax.random.bits`` (the cipher of the counter (0, i) for word i, its two
output words xored). ``fold_in_keys(keys, data)`` folds every datum
into every key of a batch in one numpy cipher; ``fold_in_batch`` (the
data pipeline's per-step keys), ``split`` and the shard keys go through
it. ``fold`` is another function: the draw
kernels' in-kernel stream fold, the cipher of (data, 0), and the streams
of ``uniforms`` depend on it.

``uniforms`` is the wrapper around the device cipher (``fused_draw.cu``'s
``threefry_uniforms_kernel``): it has no place on the draw path, where the
cipher runs inside the fused kernel, and exists so a check can hold the
device cipher against the plain one.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.config import resolve_device

__all__ = ["key", "key_words", "key_batch", "split", "keys", "fold_in",
           "fold_in_batch", "fold_in_keys", "random_bits", "threefry2x32",
           "fold",
           "bits_to_uniform", "uniforms_plain", "uniforms"]

M32 = 0xFFFFFFFF
_ROT_A = (13, 15, 26, 6)
_ROT_B = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA


def key(seed: int) -> np.ndarray:
    """The (2,) uint32 key words of ``jax.random.key(seed)`` (threefry)."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([(s >> 32) & M32, s & M32], np.uint32)


def key_words(k) -> tuple:
    """A key (anything holding two uint32 words) as two Python ints."""
    a = np.asarray(k.cpu() if isinstance(k, torch.Tensor) else k)
    a = a.astype(np.int64).reshape(-1)
    if a.shape != (2,):
        raise ValueError(f"a key is two uint32 words, got shape {a.shape}")
    return int(a[0]) & M32, int(a[1]) & M32


def key_batch(ks) -> np.ndarray:
    """A batch of keys (anything holding (B, 2) uint32 words: a numpy
    array, a tensor of any integer type, a list of keys) as a (B, 2)
    uint32 array on the host."""
    a = np.asarray(ks.cpu() if isinstance(ks, torch.Tensor) else ks)
    a = a.astype(np.int64)
    if a.ndim != 2 or a.shape[1] != 2:
        raise ValueError(f"a batch of keys is (B, 2) words, got {a.shape}")
    return (a & M32).astype(np.uint32)


def split(k, num: int) -> np.ndarray:
    """The (num, 2) uint32 words of ``jax.random.split(k, num)``: key i is
    the cipher of the counter (0, i) under ``k`` (jax's partitionable
    split), which is ``fold_in(k, i)``."""
    return fold_in_batch(k, range(int(num)))


def keys(seed: int, num: int) -> np.ndarray:
    """The canonical keys of a batch of ``num`` draws from ``seed``:
    ``split(key(seed), num)``."""
    return split(key(seed), num)


def fold_in(k, data: int) -> np.ndarray:
    """The (2,) uint32 words of ``jax.random.fold_in(k, data)``: the
    cipher of the counter (0, data) under ``k``, ``data`` taken mod 2^32
    as jax takes it. Not ``fold``, which ciphers (data, 0)."""
    k0, k1 = key_words(k)
    return np.array(threefry2x32(k0, k1, 0, int(data) & M32), np.uint32)


def fold_in_batch(k, steps) -> np.ndarray:
    """The (B, 2) uint32 words of ``fold_in(k, s)`` for each of ``steps``
    (a sequence of ints): ``fold_in_keys`` of the one key."""
    return fold_in_keys([key_words(k)], steps)[:, 0]


def fold_in_keys(ks, data) -> np.ndarray:
    """The (D, B, 2) uint32 words of ``fold_in(ks[b], data[d])`` for each
    of ``data`` (a sequence of ints) and each key of a batch
    (``key_batch``'s forms), in one vectorized cipher on the host (numpy:
    a cipher of a few words costs microseconds, not the milliseconds of
    tensor ops)."""
    w = key_batch(ks).astype(np.int64)
    d = np.asarray(data, np.int64).reshape(-1, 1) & M32
    shape = (d.shape[0], w.shape[0])
    x0, x1 = threefry2x32(np.broadcast_to(w[:, 0], shape),
                          np.broadcast_to(w[:, 1], shape),
                          np.zeros(shape, np.int64), np.broadcast_to(d, shape))
    return np.stack([x0, x1], axis=-1).astype(np.uint32)


def random_bits(k, n: int) -> np.ndarray:
    """The (n,) uint32 words of ``jax.random.bits(k, (n,))`` (jax's
    partitionable Threefry): word i is ``x0 ^ x1`` of the cipher of the
    64-bit counter i, as (hi, lo) words, under ``k``."""
    k0, k1 = key_words(k)
    i = np.arange(int(n), dtype=np.int64)
    x0, x1 = threefry2x32(k0, k1, i >> 32, i & M32)
    return (x0 ^ x1).astype(np.uint32)


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & M32


def threefry2x32(k0: int, k1: int, x0, x1):
    """The 20-round Threefry-2x32 block cipher on words in [0, 2^32):
    Python ints or int64 tensors. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for group, rot in enumerate((_ROT_A, _ROT_B, _ROT_A, _ROT_B, _ROT_A)):
        for d in rot:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, d) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & M32
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & M32
    return x0, x1


def fold(k, data: int) -> tuple:
    """Subkey of stream ``data``: the stream id encrypted under ``k`` as
    the counter (data, 0), as the reference's kernels fold it in-kernel.
    Not ``jax.random.fold_in`` (that is ``fold_in``)."""
    k0, k1 = key_words(k)
    return threefry2x32(k0, k1, int(data) & M32, 0)


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64 lanes) -> float32 uniforms in [0, 1): the top
    23 bits as the mantissa of a float in [1, 2), minus 1 (exact)."""
    mant = (bits >> 9) | 0x3F800000
    return mant.to(torch.int32).view(torch.float32) - 1.0


def uniforms_plain(k, n: int, stream: int = 0, device="cpu") -> torch.Tensor:
    """``n`` float32 uniforms from counter lanes 0..n-1 of ``stream``."""
    s0, s1 = fold(k, stream)
    ctr = torch.arange(n, dtype=torch.int64, device=device)
    x0, _ = threefry2x32(s0, s1, ctr, torch.zeros_like(ctr))
    return bits_to_uniform(x0)


def uniforms(k, n: int, stream: int = 0, device=None) -> torch.Tensor:
    """The same uniforms from the device cipher on a CUDA ``device`` (by
    default the card: ``None`` raises where there is none); the plain
    version when ``device='cpu'`` is asked for."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return uniforms_plain(k, n, stream, dev)
    if dev.type != "cuda":
        raise ValueError(f"uniforms: unsupported device {dev}")
    from . import build

    fn = build.library("fused_draw").threefry_uniforms_launch
    fn.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    k0, k1 = key_words(k)
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream_ptr = torch.cuda.current_stream(dev).cuda_stream
        build.check(fn(k0, k1, int(stream) & M32, out.data_ptr(), n,
                       stream_ptr), "threefry_uniforms")
    uniforms.launches += 1
    return out


uniforms.launches = 0
