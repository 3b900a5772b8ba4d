"""Int8 gradient compression with error feedback (``repro_torch.parallel.
compress``) against the reference (``repro.parallel.compress``) on the CPU,
bit for bit:

  * ``compress_int8`` / ``decompress_int8`` on float32 and bf16 gradients
    from seeded numpy, on zeros (the 1e-12 floor), and on ties at .5
    (round half to even, as ``jnp.round``), the clip at +-127 included;
  * ``compressed_psum_grads`` over a mesh of four CPU entries against the
    reference under ``jax.vmap(..., axis_name="data")`` (its ``pmax`` and
    ``psum`` over the mapped axis), float32 and bf16 leaves, with and
    without a carried error;
  * error feedback: the accumulated dequantized updates stay within one
    quantization step of the true sum (``tests/test_substrates.py``'s
    property), for one tensor and through ``compressed_psum_grads``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.parallel.compress import compress_int8 as r_compress
from repro.parallel.compress import compressed_psum_grads as r_psum
from repro.parallel.compress import decompress_int8 as r_decompress
from repro_torch.launch.mesh import make_mesh
from repro_torch.parallel import (compress_int8, compressed_psum_grads,
                                  decompress_int8)

N_ENTRIES = 4


def bits(a) -> np.ndarray:
    a = np.atleast_1d(np.asarray(a))
    return a.view(np.uint8) if a.dtype != np.int8 else a


def to_torch(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def to_jax(t: torch.Tensor):
    """The same values in jax, bf16 through float32 (exact)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def same(a_torch: torch.Tensor, a_jax) -> bool:
    a = a_torch.float().numpy() if a_torch.dtype == torch.bfloat16 \
        else a_torch.numpy()
    b = np.asarray(jnp.asarray(a_jax).astype(jnp.float32)) \
        if a_torch.dtype == torch.bfloat16 else np.asarray(a_jax)
    return a.dtype == b.dtype and np.array_equal(bits(a), bits(b))


CASES = {
    "normal": lambda rng: rng.standard_normal((64, 33)) * 3,
    "small": lambda rng: rng.standard_normal(257) * 1e-6,
    "zeros": lambda rng: np.zeros((8, 8)),
    # scale 1 exactly: every other value an exact tie at .5
    "ties": lambda rng: np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5,
                                  126.5, -126.5, 3.5, 0.0, -127.0]),
    # a tie scaled by a scale that is not 1: 254 / 127 = 2
    "ties_scaled": lambda rng: np.array([254.0, 1.0, 3.0, 5.0, -1.0, -7.0]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(CASES))
def test_compress_int8_matches_bit_for_bit(case, dtype):
    rng = np.random.default_rng(7)
    g = to_torch(CASES[case](rng).astype(np.float32), dtype)
    q, scale = compress_int8(g)
    rq, rscale = r_compress(to_jax(g))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(),
                                                    np.asarray(rq))
    assert same(scale, rscale)
    assert same(decompress_int8(q, scale), r_decompress(rq, rscale))
    if case == "ties":
        assert q.tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126, 4, 0, -127]


def grads_of(rng, n: int):
    """n entries' gradient dicts (float32 and bf16 leaves) as numpy."""
    return [{"w": rng.standard_normal((16, 24)).astype(np.float32),
             "b": (rng.standard_normal(24) * 1e-3).astype(np.float32),
             "h": rng.standard_normal((5, 7)).astype(np.float32)}
            for _ in range(n)]


DTYPES = {"w": torch.float32, "b": torch.float32, "h": torch.bfloat16}


@pytest.mark.parametrize("with_err", [False, True])
def test_compressed_psum_grads_matches_the_reference_under_vmap(with_err):
    rng = np.random.default_rng(11)
    mesh = make_mesh((N_ENTRIES,), ("data",), devices="cpu")
    g_np = grads_of(rng, N_ENTRIES)
    e_np = [{k: (rng.standard_normal(v.shape) * 0.01 * with_err).astype(
        np.float32) for k, v in g.items()} for g in g_np]
    grads = [{k: to_torch(v, DTYPES[k]) for k, v in g.items()} for g in g_np]
    err = [{k: torch.from_numpy(v) for k, v in e.items()} for e in e_np]
    means, new_err = compressed_psum_grads(grads, err, mesh, "data")

    stack = {k: jnp.stack([to_jax(g[k]) for g in grads]) for k in DTYPES}
    estack = {k: jnp.stack([jnp.asarray(e[k]) for e in e_np])
              for k in DTYPES}
    r_means, r_err = jax.vmap(lambda g, e: r_psum(g, e, "data"),
                              axis_name="data")(stack, estack)
    for i in range(N_ENTRIES):
        for k in DTYPES:
            assert means[i][k].dtype == DTYPES[k]
            assert same(means[i][k], r_means[k][i]), (i, k)
            assert same(new_err[i][k], r_err[k][i]), (i, k)
    for k in DTYPES:  # every entry holds the same mean
        assert all(torch.equal(means[0][k], m[k]) for m in means[1:])


def test_error_feedback_keeps_the_accumulated_sum():
    """With error feedback, the accumulated applied update converges to the
    true sum: the residual stays within one quantization step."""
    rng = np.random.default_rng(0)
    true_sum = np.zeros(64)
    applied = np.zeros(64)
    err = torch.zeros(64)
    for _ in range(200):
        g = torch.from_numpy(rng.normal(size=64) * 0.01).float()
        true_sum += g.double().numpy()
        corrected = g + err
        q, s = compress_int8(corrected)
        deq = decompress_int8(q, s)
        applied += deq.double().numpy()
        err = corrected - deq
    assert np.abs(true_sum - applied).max() < 0.01


def test_compressed_psum_error_feedback_over_entries():
    """Four entries, 50 steps: every step's mean within scale / 2 of the
    exact mean of the corrected gradients, every new error within
    scale / 2, and the accumulated means within one step of the true
    accumulated mean."""
    rng = np.random.default_rng(5)
    mesh = make_mesh((N_ENTRIES,), ("data",), devices="cpu")
    err = [{"w": torch.zeros(40)} for _ in range(N_ENTRIES)]
    true = torch.zeros(40, dtype=torch.float64)
    applied = torch.zeros(40, dtype=torch.float64)
    for _ in range(50):
        grads = [{"w": torch.from_numpy(rng.normal(size=40) * 0.01).float()}
                 for _ in range(N_ENTRIES)]
        corrected = torch.stack([g["w"] + e["w"] for g, e in zip(grads, err)])
        scale = float(corrected.abs().amax(dim=1).max()) / 127.0
        means, err = compressed_psum_grads(grads, err, mesh, ("data",))
        slack = 4 * float(corrected.abs().max()) * 2.0 ** -23
        exact = corrected.double().mean(dim=0)
        assert float((means[0]["w"].double() - exact).abs().max()) \
            <= scale / 2 + slack
        assert max(float(e["w"].abs().max()) for e in err) <= scale / 2 + slack
        true += torch.stack([g["w"] for g in grads]).double().mean(dim=0)
        applied += means[0]["w"].double()
    assert float((true - applied).abs().max()) <= scale


def test_compressed_psum_checks_the_entries():
    mesh = make_mesh((N_ENTRIES,), ("data",), devices="cpu")
    g = [{"w": torch.zeros(3)}] * 3
    with pytest.raises(ValueError):
        compressed_psum_grads(g, g, mesh, "data")
