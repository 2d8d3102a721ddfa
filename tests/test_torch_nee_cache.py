"""K7, the any-hit that reports the blocking cluster, and the occluder
cache's two passes around it (``kernels/sparse.py:sparse_any_hit_cached_cm``,
``guess_lists``), against the JAX package's ``kernels/sparse_pallas.py``:
``guess_worklist`` called directly, and ``sparse_any_hit_cached_cm`` with its
Pallas kernels in interpret mode on the CPU, as tests/test_nee_cache.py runs
them.

Tolerances: occlusion bits equal the port's K6 on every lane for any cache
contents, and JAX's except on grazing rays (within 1e-5, float64, of
flipping). Guess lists equal ``guess_worklist``'s ids, order and counts.
Blocking clusters equal JAX's on every lane whose bits agree; every
reported cluster holds a triangle that blocks its lane (float64 margin
above -1e-5).

The wavefronts are 1,024 lanes, two whole blocks of 512, on 8 clusters: the
JAX work lists stay far below its interpret-mode cap of 256 entries (past
it JAX takes its dense fallback, which reports no cluster), and no pad
lane exists (JAX pads a ragged block by repeating the last lane, guess
included; the port pads the guess with -1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.kernels import sparse_pallas as sp
from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu_torch.kernels import sparse
from pathtracerpython_tpu_torch.scene import arrays, synthetic
from torch_parity import (
    GRAZING_MARGIN,
    decode_grouped,
    occlusion_margin_f64,
    to_jax_desc,
)

R_BLK = sparse.R_BLK
N = 2 * R_BLK
N_CLUSTERS = 8


@pytest.fixture(scope="module")
def field():
    """box_field(80): 964 triangles in morton order, 8 clusters."""
    desc = synthetic.box_field_scene(n_boxes=80, width=24, height=24)
    return (arrays.pack_scene(desc, tri_order="morton", device="cpu"),
            jax_arrays.pack_scene(to_jax_desc(desc), morton_order=True))


def _shadow_rays(scene, n=N, seed=0):
    """Shadow rays aimed through occluder triangles (the centroid at t =
    0.5), picked in buffer (morton) order so that ray blocks are coherent,
    as the integrator's sorting makes them; every fourth lane's window ends
    before its triangle (0.3). Mostly occluded: the population the cache
    is built for. As numpy."""
    rs = np.random.default_rng(seed)
    rows = np.nonzero(scene.tri_occluder.numpy())[0]
    rows = np.sort(rs.choice(rows, n, replace=True))
    c = (scene.tri_v0.numpy()[rows] + scene.tri_v1.numpy()[rows]
         + scene.tri_v2.numpy()[rows]) / 3.0
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = (c - 0.5 * d).astype(np.float32)
    maxd = np.where(np.arange(n) % 4 == 3, 0.3, 1.0).astype(np.float32)
    return (np.ascontiguousarray(o.T), np.ascontiguousarray(d.T), maxd)


def _torch(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _cold(n=N):
    return torch.full((n,), -1, dtype=torch.int32)


def _cache(kind, scene, rays):
    """The guess of each case: cold, the cache a first call returned, random
    cluster ids, and ids outside the cluster range."""
    rs = np.random.default_rng(7)
    if kind == "cold":
        return _cold()
    if kind == "returned":
        return sparse.sparse_any_hit_cached_cm(*rays, scene, _cold())[1]
    lo, hi = (0, N_CLUSTERS) if kind == "garbage" else (-3, 3 * N_CLUSTERS)
    return torch.from_numpy(rs.integers(lo, hi, N).astype(np.int32))


GUESSES = {
    # block 0: clusters 5 and 2 tie at 10 votes (2 first), then 7;
    # block 1: nine clusters' worth of votes, more than K_GUESS columns
    "tie": lambda rs: np.concatenate([
        np.repeat([5, 2, 7, -1], [10, 10, 3, R_BLK - 23]),
        np.repeat(np.arange(8), np.arange(8, 0, -1) * 3)[:R_BLK],
        np.full(R_BLK - 108, -1)]),
    "random": lambda rs: rs.integers(-3, 3 * N_CLUSTERS, N),
    "cold": lambda rs: np.full(N, -1),
}


@pytest.mark.parametrize("kind", sorted(GUESSES))
def test_guess_lists_match_guess_worklist(kind):
    guess = GUESSES[kind](np.random.default_rng(1)).astype(np.int32)
    assert guess.shape == (N,)
    lists = sparse.guess_lists(torch.from_numpy(guess), N_CLUSTERS, R_BLK)
    packs, jncand, _ = sp.guess_worklist(
        jnp.asarray(guess), r_blk=R_BLK, n_clusters=N_CLUSTERS,
        k_guess=sp.K_GUESS, group=2)
    np.testing.assert_array_equal(lists.ncand.numpy(), np.asarray(jncand))
    want = decode_grouped(packs, N // R_BLK, ordered=True)
    for b in range(N // R_BLK):
        assert lists.ids[b, :int(lists.ncand[b])].tolist() == want[b]
    assert (lists.keys == 0).all() and lists.ids.dtype == torch.int32
    if kind == "tie":
        assert lists.ids[0, :3].tolist() == [2, 5, 7]
        assert lists.ncand.tolist() == [3, 8]
    if kind == "cold":
        assert lists.ncand.tolist() == [0, 0]


def test_guess_lists_drop_the_pad_lanes_of_a_ragged_block():
    guess = torch.full((R_BLK + 10,), 3, dtype=torch.int32)
    lists = sparse.guess_lists(guess, N_CLUSTERS, R_BLK)
    assert lists.ncand.tolist() == [1, 1] and lists.ids[:, 0].tolist() == [3, 3]
    k = sparse.guess_lists(guess, 4, R_BLK, k_guess=8).ids.shape[1]
    assert k == 4  # never more columns than clusters


@pytest.mark.parametrize("kind", ["cold", "returned", "garbage",
                                  "out_of_range"])
def test_cached_occlusion_is_exact_for_any_cache(field, kind):
    scene, _ = field
    rays = _torch(*_shadow_rays(scene))
    want = sparse.sparse_any_hit_cm(*rays, scene)
    assert 0.5 < want.float().mean() < 0.999
    occ, cl = sparse.sparse_any_hit_cached_cm(
        *rays, scene, _cache(kind, scene, rays))
    assert torch.equal(occ, want)
    assert cl.dtype == torch.int32 and torch.equal(cl >= 0, occ)
    assert int(cl.max()) < N_CLUSTERS


def test_reported_clusters_hold_a_blocking_triangle(field):
    """In float64, against the occluder triangles of the reported cluster
    alone."""
    scene, _ = field
    o3, d3u, maxd = _shadow_rays(scene, seed=3)
    occ, cl = sparse.sparse_any_hit_cached_cm(*_torch(o3, d3u, maxd), scene,
                                              _cold())
    tripack = sparse.pack_for_sparse(scene).numpy()
    lanes = np.nonzero(cl.numpy() >= 0)[0]
    assert len(lanes) > 500
    for i in lanes[::8]:
        c = int(cl[i])
        rows = tripack[c * sparse.C_TRI:(c + 1) * sparse.C_TRI]
        rows = rows[(rows[:, 9] > 0.5) & (rows[:, 10] > 0.5)]
        margin = occlusion_margin_f64(rows[:, 0:3], rows[:, 3:6],
                                      rows[:, 6:9], o3[:, i], d3u[:, i],
                                      maxd[i])
        assert margin > -GRAZING_MARGIN, (i, c, margin)


def _relevant(n=N):
    """Two lanes in three relevant, and the tail of block 1 not at all."""
    rel = np.arange(n) % 3 != 0
    rel[n - 200:] = False
    return rel


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("kind", ["cold", "returned", "out_of_range"])
def test_cached_matches_jax(field, kind, masked):
    """Bits and blocking clusters against JAX's protocol: the same pass-1
    votes, the same small/big choice for pass 2, the same compaction."""
    scene, ref = field
    o3, d3u, maxd = _shadow_rays(scene)
    rel = _relevant() if masked else None
    if masked:  # the caller parks what it will discard
        maxd = np.where(rel, maxd, 0.0).astype(np.float32)
    rays = _torch(o3, d3u, maxd)
    guess = _cache(kind, scene, rays)
    occ, cl = sparse.sparse_any_hit_cached_cm(
        *rays, scene, guess,
        relevant=None if rel is None else torch.from_numpy(rel))
    jocc, jcl = sp.sparse_any_hit_cached_cm(
        jnp.asarray(o3), jnp.asarray(d3u), jnp.asarray(maxd), ref,
        jnp.asarray(guess.numpy()),
        relevant=None if rel is None else jnp.asarray(rel))
    occ, cl, jocc, jcl = (np.asarray(x) for x in (occ, cl, jocc, jcl))
    lanes = np.ones(N, bool) if rel is None else rel
    bad = np.nonzero((occ != jocc) & lanes)[0]
    assert len(bad) <= 0.01 * N
    occluders = scene.tri_occluder.numpy()
    tris = [v.numpy()[occluders] for v in (scene.tri_v0, scene.tri_v1,
                                           scene.tri_v2)]
    for r in bad:
        margin = occlusion_margin_f64(*tris, o3[:, r], d3u[:, r], maxd[r])
        assert abs(margin) < GRAZING_MARGIN, (r, margin)
    same = (occ == jocc) & lanes
    np.testing.assert_array_equal(cl[same], jcl[same])
    assert (cl[same] >= 0).sum() > 100


def _record(monkeypatch, name):
    """Record the lane counts ``sparse.<name>`` is called with."""
    calls = []
    real = getattr(sparse, name)

    def spy(*args, **kw):
        first = args[1] if name == "window_lists" else args[0]
        calls.append(first.shape[-1])
        return real(*args, **kw)

    monkeypatch.setattr(sparse, name, spy)
    return calls


def test_pass_two_is_whole_for_a_cold_cache_and_compacted_for_a_warm(
        field, monkeypatch):
    scene, _ = field
    rays = _torch(*_shadow_rays(scene))
    calls = _record(monkeypatch, "window_lists")
    _, cl = sparse.sparse_any_hit_cached_cm(*rays, scene, _cold())
    assert calls == [N]            # every lane open: the whole wavefront
    assert sparse.pass2_size(N) == R_BLK and sparse.pass2_size(3000) == 1536
    calls.clear()
    occ, _ = sparse.sparse_any_hit_cached_cm(*rays, scene, cl)
    # the returned cache resolves the occluded lanes in pass 1; what is
    # left fits pass2_size(N) = one block
    assert calls == [R_BLK]
    assert int((~occ).sum()) <= R_BLK


def test_parked_lanes_do_not_vote_and_skip_pass_two(field, monkeypatch):
    scene, _ = field
    o3, d3u, maxd = _torch(*_shadow_rays(scene))
    rel = torch.from_numpy(_relevant())
    maxd = torch.where(rel, maxd, 0.0)
    seen = []
    real = sparse.guess_lists
    monkeypatch.setattr(
        sparse, "guess_lists",
        lambda guess, *a, **k: seen.append(guess.clone()) or real(
            guess, *a, **k))
    guess = torch.full((N,), 4, dtype=torch.int32)
    occ, cl = sparse.sparse_any_hit_cached_cm(o3, d3u, maxd, scene, guess,
                                              relevant=rel)
    assert (seen[0][~rel] == -1).all() and (seen[0][rel] == 4).all()
    assert not occ[~rel].any() and (cl[~rel] == -1).all()
    want = sparse.sparse_any_hit_cm(o3, d3u, maxd, scene)
    assert torch.equal(occ[rel], want[rel])


def test_wrapper_refuses_bad_inputs(field):
    scene, _ = field
    o3, d3, maxd = torch.zeros(3, 8), torch.zeros(3, 8), torch.zeros(8)
    with pytest.raises(TypeError, match="dtype"):
        sparse.sparse_any_hit_cached_cm(o3, d3, maxd, scene,
                                        torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError, match="shape"):
        sparse.sparse_any_hit_cached_cm(o3, d3, maxd, scene, _cold(7))
    with pytest.raises(TypeError, match="dtype"):
        sparse.sparse_any_hit_cached_cm(o3, d3, maxd, scene, _cold(8),
                                        relevant=torch.zeros(8))
    occ, cl = sparse.sparse_any_hit_cached_cm(
        torch.zeros(3, 0), torch.zeros(3, 0), torch.zeros(0), scene, _cold(0))
    assert occ.shape == cl.shape == (0,)
