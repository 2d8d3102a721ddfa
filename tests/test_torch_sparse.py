"""K5, the cluster-sparse nearest sweep, and the cluster hierarchy's
candidate lists (``kernels/sparse.py``) against the JAX package's
``kernels/sparse_pallas.py``: its XLA-side builders called directly, and
its Pallas kernel in interpret mode on the CPU, as tests/test_sparse.py
runs it.

Tolerances: the lists are compared as sets per block (``lax.top_k`` and
``torch.sort`` may order clusters of equal entry bound differently, and no
result depends on that), entry bounds within 1e-6; the sweep's winners
are equal except on grazing pairs (float64 barycentric margin < 1e-5) and
t within 1e-6, the bounds of tests/torch_parity.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.kernels import sparse_pallas as sp
from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu_torch.kernels import intersect, sparse
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.ops.geometry import normalize3
from pathtracerpython_tpu_torch.ops.sort import PARK_DIR, PARK_ORIGIN
from pathtracerpython_tpu_torch.scene import arrays, synthetic
from torch_parity import (
    GRAZING_MARGIN,
    T_ATOL,
    T_RTOL,
    bary_margin_f64,
    decode_grouped,
    to_jax_desc,
)

R_BLK = sparse.R_BLK_HYBRID_NEAREST


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: with one intra-op thread these tests take
    the same time alone and do not fight the other test workers for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def field():
    """box_field(80): 964 triangles in morton order, 8 clusters."""
    desc = synthetic.box_field_scene(n_boxes=80, width=24, height=24)
    return (arrays.pack_scene(desc, tri_order="morton", device="cpu"),
            jax_arrays.pack_scene(to_jax_desc(desc), morton_order=True))


def _rays(scene, kind, n=3000, seed=0):
    """o3, d3u f32[3, n] as numpy: "random" rays inside the field (the
    incoherent case), "primary" camera rays plus random ones, or "parked":
    random rays with the first 1024 lanes and one later run parked, as the
    integrator parks dead lanes."""
    rs = np.random.default_rng(seed)
    o = rs.uniform([-8, -1, -16], [8, 1.5, 3], (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    if kind == "primary":
        po, pd = make_primary_rays(scene.eye, scene.ortho, scene.meta.width,
                                   scene.meta.height)
        o = np.concatenate([po.numpy(), o])[:n]
        d = np.concatenate([pd.numpy(), d])[:n]
    if kind == "parked":
        for lo, hi in ((0, 1024), (2300, 2650)):
            o[lo:hi] = PARK_ORIGIN
            d[lo:hi] = PARK_DIR
    o3 = np.ascontiguousarray(o.T)
    d3u = normalize3(torch.from_numpy(np.ascontiguousarray(d.T))).numpy()
    return o3, d3u


def _jax_enter_hit(ref, o3, d3u, tmax, r_blk):
    aabb8 = sp.cluster_aabbs(sp._pack_for_sparse(ref, sp.C_TRI), sp.C_TRI)
    o3p = sp._pad_repeat_last(jnp.asarray(o3), r_blk)
    d3p = sp._pad_repeat_last(jnp.asarray(d3u), r_blk)
    return aabb8, o3p, d3p


def test_cluster_aabbs_match_jax(field):
    scene, ref = field
    tripack = sparse.pack_for_sparse(scene)
    jpack = sp._pack_for_sparse(ref, sp.C_TRI)
    np.testing.assert_array_equal(tripack.numpy(), np.asarray(jpack))
    assert tripack.shape[0] % 512 == 0
    got = sparse.cluster_aabbs(tripack).numpy()
    want = np.asarray(sp.cluster_aabbs(jpack, sp.C_TRI))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (8, 8)


@pytest.mark.parametrize("kind", ["random", "primary", "parked"])
@pytest.mark.parametrize("r_blk", [256, R_BLK])
def test_candidate_enter_hit_matches_jax(field, kind, r_blk):
    scene, ref = field
    o3, d3u = _rays(scene, kind)
    nrb = -(-o3.shape[1] // r_blk)
    tmax = np.random.default_rng(1).uniform(0.5, 30.0, nrb).astype(
        np.float32)
    aabb8 = sparse.cluster_aabbs(sparse.pack_for_sparse(scene))
    enter, hit = sparse.candidate_enter_hit(
        aabb8, torch.from_numpy(o3), torch.from_numpy(d3u),
        torch.from_numpy(tmax), r_blk)
    jaabb8, o3p, d3p = _jax_enter_hit(ref, o3, d3u, tmax, r_blk)
    jenter, jhit = sp._candidate_enter_hit(jaabb8, o3p, d3p,
                                           jnp.asarray(tmax), r_blk)
    jenter, jhit = np.asarray(jenter), np.asarray(jhit)
    np.testing.assert_array_equal(hit.numpy(), jhit)
    np.testing.assert_allclose(enter.numpy()[jhit], jenter[jhit], rtol=1e-6,
                               atol=1e-6)
    assert jhit.any()
    if kind == "parked":  # the parked block touches no cluster
        assert not jhit[0].any()


@pytest.mark.parametrize("kind", ["random", "primary", "parked"])
def test_block_lists_match_grouped_worklist(field, kind):
    scene, ref = field
    o3, d3u = _rays(scene, kind)
    nrb = -(-o3.shape[1] // R_BLK)
    tmax = np.full(nrb, intersect.BIG, np.float32)
    aabb8 = sparse.cluster_aabbs(sparse.pack_for_sparse(scene))
    lists = sparse.block_lists(aabb8, torch.from_numpy(o3),
                               torch.from_numpy(d3u), torch.from_numpy(tmax),
                               R_BLK)
    jaabb8, o3p, d3p = _jax_enter_hit(ref, o3, d3u, tmax, R_BLK)
    n_clusters = jaabb8.shape[0]
    packs, jncand, overflow = sp.grouped_worklist(
        jaabb8, o3p, d3p, jnp.asarray(tmax), r_blk=R_BLK, maxc=sp.MAXC,
        w_cap=nrb * n_clusters, group=2)
    assert not bool(overflow)
    np.testing.assert_array_equal(lists.ncand.numpy(), np.asarray(jncand))
    want = decode_grouped(packs, nrb)
    for b in range(nrb):
        k = int(lists.ncand[b])
        ids = lists.ids[b, :k].tolist()
        assert set(ids) == want[b] and len(ids) == k
        keys = lists.keys[b, :k]
        assert bool((keys[1:] >= keys[:-1]).all())   # front to back
        assert bool((keys >= 0).all())
        assert bool((lists.keys[b, k:] == intersect.BIG).all())
    if kind == "parked":  # block 0 holds parked lanes only
        assert lists.ncand[0] == 0 and (lists.ncand[1:] > 0).all()


def _assert_winners_match(scene, o3, d3u, t, idx, want_t, want_idx):
    same = idx == want_idx
    bad = np.nonzero(~same)[0]
    assert len(bad) <= 0.01 * len(idx), f"{len(bad)} winner mismatches"
    tri = [scene.tri_v0.numpy(), scene.tri_v1.numpy(), scene.tri_v2.numpy()]
    for r in bad:
        margins = [abs(bary_margin_f64(tri[0][i], tri[1][i], tri[2][i],
                                       o3[:, r], d3u[:, r]))
                   for i in (idx[r], want_idx[r]) if i >= 0]
        assert margins and min(margins) < GRAZING_MARGIN, (r, margins)
    np.testing.assert_allclose(t[same], want_t[same], rtol=T_RTOL,
                               atol=T_ATOL)
    assert (t[idx < 0] == 0.0).all()


@pytest.mark.parametrize("kind", ["random", "primary", "parked"])
def test_plain_sparse_nearest_matches_jax_kernel_and_dense(field, kind):
    scene, ref = field
    o3, d3u = _rays(scene, kind)
    t, idx = sparse.sparse_nearest_t_idx_cm(torch.from_numpy(o3),
                                            torch.from_numpy(d3u), scene,
                                            r_blk=R_BLK)
    t, idx = t.numpy(), idx.numpy()
    assert idx.dtype == np.int32 and t.dtype == np.float32
    assert (idx >= 0).mean() > 0.1 and (idx < 0).any()
    if kind == "parked":
        assert (idx[:1024] == -1).all() and (idx[2300:2650] == -1).all()
    jt, jidx = map(np.asarray, sp.sparse_nearest_t_idx_cm(
        jnp.asarray(o3), jnp.asarray(d3u), ref, r_blk=R_BLK,
        w_per_rb=sp.W_PER_RB_HYBRID_NEAREST,
        chunk_rb=sp.CHUNK_RB_HYBRID_NEAREST))
    _assert_winners_match(scene, o3, d3u, t, idx, jt, jidx)
    dt, didx = intersect.nearest_t_idx_cm(torch.from_numpy(o3),
                                          torch.from_numpy(d3u), scene)
    np.testing.assert_array_equal(idx, didx.numpy())
    np.testing.assert_array_equal(t, dt.numpy())


def test_blocks_without_candidates_miss(field):
    """Rays pointing away from all geometry: empty lists, clean misses."""
    scene, _ = field
    n = 1500
    o3 = torch.tensor([0.0, 50.0, 0.0])[:, None].expand(3, n).contiguous()
    d3 = torch.tensor([0.0, 1.0, 0.0])[:, None].expand(3, n).contiguous()
    aabb8 = sparse.cluster_aabbs(sparse.pack_for_sparse(scene))
    lists = sparse.block_lists(aabb8, o3, d3,
                               torch.full((2,), intersect.BIG), R_BLK)
    assert (lists.ncand == 0).all()
    t, idx = sparse.sparse_nearest_t_idx_cm(o3, d3, scene)
    assert (idx == -1).all() and (t == 0).all()


@pytest.mark.parametrize("accel,n_tris", [
    ("auto", sparse.SPARSE_MIN_TRIS), ("auto", sparse.SPARSE_MIN_TRIS - 1),
    ("auto", 32), ("none", 10**5), ("hybrid", 32), ("sparse", 32),
    ("walker", 10**5),
])
def test_resolve_accel_matches_jax(accel, n_tris):
    assert sparse.resolve_accel(accel, n_tris) == sp.resolve_accel(
        accel, n_tris)
    assert sparse.use_sparse(accel, n_tris) == sp.use_sparse(accel, n_tris)
    if accel == "auto":
        want = "hybrid" if n_tris >= 4096 else "none"
        assert sparse.resolve_accel(accel, n_tris) == want


def test_wrapper_refuses_bad_inputs(field):
    scene, _ = field
    o3 = torch.zeros(3, 8, requires_grad=True)
    d3 = torch.zeros(3, 8)
    # rays that require grad are no fault since K5 carries its gradient
    t, idx = sparse.sparse_nearest_t_idx_cm(o3, d3, scene)
    assert t.requires_grad and not idx.requires_grad
    want = sparse.sparse_nearest_t_idx_cm(o3.detach(), d3, scene)
    assert torch.equal(t.detach(), want[0]) and torch.equal(idx, want[1])
    with pytest.raises(ValueError, match="shape"):
        sparse.sparse_nearest_t_idx_cm(torch.zeros(3, 8), d3[:, :4], scene)
