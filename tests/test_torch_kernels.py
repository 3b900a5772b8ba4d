"""The port's kernel wrappers (on the CPU: their plain versions) against
the JAX reference's kernels in Pallas interpret mode, on the same inputs.

  * Threefry bits and uniforms: exact.
  * ``bsearch_probe``, ``tree_probe`` and ``usr_get_rows``: exact, on
    arenas carried across from the reference by ``shred_from_arrays``.
  * ``fused_draw_params``: int arrays exact; float32 arrays at most 1 ulp
    (both packages sum the float64 mass prefix in their own order before
    the cast, and their float64 ``log1p`` may differ in the last bit).
  * The arrivals ascend (a running max follows the kernel-ordered sum).
  * ``draw_core``: positions, count, overflow and rows equal, except where
    an arrival lands in a neighbouring cell because the reference arrival
    lies within 4 float32 ulp of a cell boundary (XLA orders the float32
    cumsum its own way, and the CPU ``log1p`` may differ by 1 ulp); the
    test checks that every such lane is one.

The wrappers' CUDA legs run only on a card, where ``chip_smoke.py``
holds each kernel against its plain version (the machine with the card
has no JAX, so these parity tests run here).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import Atom, Database, JoinQuery, build_shred, probe, sampling
from repro.kernels import threefry as r_threefry
from repro.kernels.bsearch_probe import bsearch_probe as r_bsearch
from repro.kernels.fused_draw import fused_draw_ref as r_fused_draw_ref
from repro.kernels.tree_probe import tree_probe as r_tree_probe
from repro_torch.core import probe as t_probe
from repro_torch.core import sampling as t_sampling
from repro_torch.core import shred_from_arrays
from repro_torch.kernels import fused_draw as t_fd
from repro_torch.kernels import ops as t_ops
from repro_torch.kernels import threefry as t_threefry
from repro_torch.kernels.bsearch_probe import bsearch_probe as t_bsearch
from repro_torch.kernels.tree_probe import tree_probe as t_tree_probe

from test_torch_shred import ref_arrays


def star_chain(seed, n_t=40, dist_p=None):
    """A small job_like-shaped database (Title -> Cast -> Comp chain after
    GYO) with p on the root, from numpy."""
    rng = np.random.default_rng(seed)
    p = rng.beta(2, 10, n_t) if dist_p is None else dist_p(rng, n_t)
    tables = {
        "Title": {"t": np.arange(n_t), "kind": rng.integers(0, 7, n_t),
                  "p": p},
        "Cast": {"t": rng.integers(0, n_t, 4 * n_t),
                 "person": rng.integers(0, 2 * n_t, 4 * n_t)},
        "Comp": {"t": rng.integers(0, n_t, 2 * n_t),
                 "comp": rng.integers(0, 50, 2 * n_t)},
    }
    q = JoinQuery((Atom.of("Title", "t", "kind", "p"),
                   Atom.of("Cast", "t", "person"),
                   Atom.of("Comp", "t", "comp")), prob_var="p")
    return tables, q


def ref_and_port_shred(seed, **kw):
    tables, q = star_chain(seed, **kw)
    ref = build_shred(Database.from_columns(tables), q)
    return ref, shred_from_arrays(ref_arrays(ref), device="cpu")


# --- Threefry ----------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5, 123456789, 2**40 + 7, -3])
def test_key_words_match_jax(seed):
    want = np.asarray(jax.random.key_data(jax.random.key(seed)))
    np.testing.assert_array_equal(t_threefry.key(seed), want.astype(np.uint32))


def test_threefry_bits_and_uniforms_exact():
    rng = np.random.default_rng(0)
    for seed in range(4):
        kd = jax.random.key_data(jax.random.key(seed)).astype(jnp.uint32)
        x0 = rng.integers(0, 2**32, 257, dtype=np.uint64)
        x1 = rng.integers(0, 2**32, 257, dtype=np.uint64)
        w0, w1 = r_threefry.threefry2x32(kd, jnp.asarray(x0, jnp.uint32),
                                         jnp.asarray(x1, jnp.uint32))
        k0, k1 = t_threefry.key_words(t_threefry.key(seed))
        g0, g1 = t_threefry.threefry2x32(k0, k1,
                                         torch.as_tensor(x0.astype(np.int64)),
                                         torch.as_tensor(x1.astype(np.int64)))
        np.testing.assert_array_equal(np.asarray(w0, np.int64), g0.numpy())
        np.testing.assert_array_equal(np.asarray(w1, np.int64), g1.numpy())
        for stream in (0, 1):
            want = np.asarray(r_threefry.uniforms(kd, 1000, stream))
            got = t_threefry.uniforms(t_threefry.key(seed), 1000, stream,
                                      device="cpu")
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(want, got.numpy())


# --- bsearch_probe -----------------------------------------------------------

@pytest.mark.parametrize("np_len", [1, 2, 3, 17, 1000])
def test_bsearch_probe_exact(np_len):
    rng = np.random.default_rng(np_len)
    pref = np.concatenate([[0], np.cumsum(rng.integers(0, 4, np_len - 1))])
    pref = pref.astype(np.int32)
    q = rng.integers(0, int(pref[-1]) + 3, (3, 128)).astype(np.int32)
    want = np.asarray(r_bsearch(jnp.asarray(pref), jnp.asarray(q),
                                interpret=True))
    got = t_bsearch(torch.from_numpy(pref), torch.from_numpy(q))
    np.testing.assert_array_equal(want, got.numpy())
    # The dispatching wrapper: the same answer through the library search
    # for int64 operands.
    np.testing.assert_array_equal(
        want.reshape(-1),
        t_ops.searchsorted_prefix(torch.from_numpy(pref).long(),
                                  torch.from_numpy(q).long().reshape(-1)).numpy())


def test_to_tiles_pads_rows():
    t = t_ops.to_tiles(torch.arange(130, dtype=torch.int32), fill=-1)
    assert t.shape == (2, 128) and int(t[1, 2]) == -1 and int(t[1, 1]) == 129


# --- tree_probe / usr_get_rows -----------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_probe_exact(seed):
    ref, port = ref_and_port_shred(seed)
    n = int(ref.join_size)
    pos = np.arange(n, dtype=np.int32)
    tiles = np.pad(pos, (0, (-n) % 128), constant_values=n - 1).reshape(-1, 128)
    want = np.asarray(r_tree_probe(ref.packed.arena, jnp.asarray(tiles),
                                   layout=ref.packed.layout, interpret=True))
    got = t_tree_probe(port.packed.arena, torch.from_numpy(tiles),
                       port.packed.layout)
    assert got.shape == want.shape and got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("seed", [0, 3])
def test_usr_get_rows_exact(seed):
    ref, port = ref_and_port_shred(seed)
    n = int(ref.join_size)
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.integers(0, n, 300))
    want = probe.usr_get_rows(ref, jnp.asarray(pos))
    per_node = t_probe.usr_get_rows(port, torch.from_numpy(pos))
    fused = t_probe.usr_get_rows_fused(port, torch.from_numpy(pos))
    for name, rows in want.items():
        np.testing.assert_array_equal(np.asarray(rows), per_node[name].numpy())
        np.testing.assert_array_equal(np.asarray(rows), fused[name].numpy())


# --- fused draw --------------------------------------------------------------

def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.astype(np.float64) - b) / np.spacing(np.maximum(
        np.abs(a), np.abs(b)))


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_draw_params_match(seed):
    dist = (None, lambda rng, n: rng.choice([0.0, 0.01, 0.3, 0.5, 0.7, 1.0], n))
    ref, port = ref_and_port_shred(seed, dist_p=dist[seed])
    p = ref.root.data.column("p")
    want = sampling.fused_draw_params(ref.root.weight, p, ref.root_prefE)
    got = t_sampling.fused_draw_params(port.root.weight,
                                       port.root.data.column("p"),
                                       port.root_prefE)
    assert set(want) == set(got)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert w.dtype == g.dtype, k
        if w.dtype == np.float32:
            assert _ulps(w, g).max() <= 1, k
        else:
            np.testing.assert_array_equal(w, g, err_msg=k)


def ref_arrivals(key_data, params, acap):
    """The reference's float32 arrivals and their cells, as numpy."""
    u = r_threefry.uniforms(key_data, acap, stream=0)
    v = np.asarray(jnp.cumsum(-jnp.log1p(-u)))
    return v, _cells(v, params)


def _cells(v, params):
    """The global cell id of every arrival (the reference's placement)."""
    massE = np.asarray(params["massE"], np.float32)
    lam = np.asarray(params["lam"], np.float32)
    w = np.asarray(params["w32"])
    prefE = np.asarray(params["prefE32"])
    R = w.shape[0]
    r = np.clip(np.searchsorted(massE, v, side="right") - 1, 0, R - 1)
    x = (v - massE[r]) / np.maximum(lam[r], np.float32(1e-12))
    cell = np.clip(np.floor(x).astype(np.int64), 0, np.maximum(w[r] - 1, 0))
    return np.where(v < massE[R], prefE[r] + cell, prefE[R])


def near_boundary(v, params, lanes, ulps=4):
    """True where arrival v lies within ``ulps`` float32 ulp of a cell
    boundary (a cell edge inside a root segment, a segment edge, or Lam)."""
    massE = np.asarray(params["massE"], np.float64)
    lam = np.asarray(params["lam"], np.float64)
    R = lam.shape[0]
    out = []
    for i in lanes:
        vi = float(v[i])
        tol = ulps * float(np.spacing(np.float32(vi)))
        r = int(np.clip(np.searchsorted(massE, vi, side="right") - 1, 0, R - 1))
        edges = [massE[r], massE[min(r + 1, R)], massE[R]]
        if r > 0:
            edges.append(massE[r - 1])
        if lam[r] > 0:
            k = np.round((vi - massE[r]) / lam[r])
            edges.append(massE[r] + k * lam[r])
        out.append(min(abs(vi - e) for e in edges) <= tol)
    return np.asarray(out)


def assert_draw_matches(want, got, v_ref, cells_ref, cells_port, params):
    """Exact equality, or every arrival whose cell differs lies within 4
    ulp of a cell boundary in the reference (and then the draws may
    differ downstream of it)."""
    diff = np.nonzero(cells_ref != cells_port)[0]
    if diff.size:
        assert near_boundary(v_ref, params, diff).all(), diff
        return False
    for g, w, what in zip(got, want, ("rows", "positions", "count", "overflow")):
        np.testing.assert_array_equal(np.asarray(w), g.numpy(), err_msg=what)
    return True


@pytest.mark.parametrize("dist", ["low", "mixed"])
def test_draw_core_matches_reference(dist):
    dists = {"low": None,
             "mixed": lambda rng, n: rng.choice([0.0, 0.02, 0.3, 0.5, 0.7,
                                                 0.98, 1.0], n)}
    exact = 0
    for seed in range(3):
        ref, port = ref_and_port_shred(seed, dist_p=dists[dist])
        p = ref.root.data.column("p")
        params = sampling.fused_draw_params(ref.root.weight, p, ref.root_prefE)
        tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
        n = int(ref.join_size)
        cap = n + 8
        acap = 2 * n + 64
        for key_seed in range(3):
            kd = jax.random.key_data(jax.random.key(key_seed)).astype(jnp.uint32)
            want = r_fused_draw_ref(ref.packed.arena, kd, params,
                                    layout=ref.packed.layout,
                                    method="exprace", cap=cap, acap=acap)
            key = t_threefry.key(key_seed)
            got = t_fd.fused_draw(port.packed.arena, key, tparams,
                                  layout=port.packed.layout, method="exprace",
                                  cap=cap, acap=acap)
            v_ref, cells_ref = ref_arrivals(kd, params, acap)
            v_port = t_fd.arrivals(key, acap, "cpu").numpy()
            assert _ulps(v_ref, v_port).max() <= 4
            exact += assert_draw_matches(want, got, v_ref, cells_ref,
                                         _cells(v_port, params), params)
            pos, cnt = got[1].numpy(), int(got[2])
            assert (np.diff(pos[:cnt]) >= 0).all() and (pos[cnt:] == n).all()
    assert exact >= 6  # most draws have no arrival near a boundary


def test_scan_order_helpers():
    rng = np.random.default_rng(0)
    for n in (1, 5, 8192, 8193, 20000):
        x = torch.from_numpy(rng.integers(-5, 6, n).astype(np.int32))
        np.testing.assert_array_equal(t_fd._scan_i32(x).numpy(),
                                      np.cumsum(x.numpy()))
        np.testing.assert_array_equal(t_fd._cummax_i32(x).numpy(),
                                      np.maximum.accumulate(x.numpy()))
        f = torch.from_numpy(rng.random(n).astype(np.float32))
        got = t_fd._scan_f32(f).numpy().astype(np.float64)
        want = np.cumsum(f.numpy().astype(np.float64))
        assert np.abs(got - want).max() <= 1e-5 * max(want[-1], 1.0)


def test_arrivals_ascend():
    """The kernel-ordered float32 sum can dip an ulp at a thread boundary
    (key 3008 at 171,776 arrivals does); the arrivals' running max keeps
    them ascending, which the draw's ascending positions rest on."""
    key = t_threefry.key(3008)
    u = t_threefry.uniforms_plain(key, 171_776, stream=0)
    raw = t_fd._scan_f32(-torch.log1p(-u))
    assert bool((raw[1:] < raw[:-1]).any())
    v = t_fd.arrivals(key, 171_776, "cpu")
    assert bool((v[1:] >= v[:-1]).all())
    assert float((v - raw).abs().max()) <= 4 * float(np.spacing(np.float32(v[-1])))


@pytest.mark.parametrize("seed", [0, 1])
def test_ptbern_draw_matches_reference_exactly(seed):
    """Flat PTBERN is integer after the uniforms: no tolerance."""
    mixed = lambda rng, n: rng.choice([0.0, 0.1, 0.5, 0.9, 1.0], n)  # noqa: E731
    ref, port = ref_and_port_shred(seed, dist_p=mixed if seed else None)
    params = sampling.fused_draw_params(ref.root.weight,
                                        ref.root.data.column("p"),
                                        ref.root_prefE)
    tparams = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    n = int(ref.join_size)
    for cap in (n + 8, max(8, n // 8)):  # the second one overflows
        for key_seed in range(2):
            kd = jax.random.key_data(jax.random.key(key_seed)).astype(jnp.uint32)
            want = r_fused_draw_ref(ref.packed.arena, kd, params,
                                    layout=ref.packed.layout,
                                    method="ptbern_flat", cap=cap, n=n)
            got = t_fd.fused_draw(port.packed.arena, t_threefry.key(key_seed),
                                  tparams, layout=port.packed.layout,
                                  method="ptbern_flat", cap=cap, n=n)
            for g, w, what in zip(got, want, ("rows", "positions", "count",
                                              "overflow")):
                np.testing.assert_array_equal(np.asarray(w), g.numpy(),
                                              err_msg=what)
