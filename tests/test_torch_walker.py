"""K8, the walker nearest sweep, and K9, the walker any-hit
(``kernels/walker.py``), against the JAX package's
``kernels/walker_pallas.py``: its list builder called directly, and its
Pallas kernels in interpret mode on the CPU, as tests/test_walker.py runs
them; and against the port's dense K1 and K4 and its sparse K5.

Tolerances: lists compared as sets per block; the port's float entry
bounds may not lie below JAX's 19-bit truncated ones. Occlusion bits are
equal except on grazing rays: a mismatch must sit within 1e-5 (float64)
of flipping against some occluder. K8's winners equal JAX's except on
grazing pairs (float64 barycentric margin < 1e-5), t within 1e-6 on equal
winners; within the port K8, K5 and K1 give the same (t, index) on every
lane."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.kernels import sparse_pallas as sp
from pathtracerpython_tpu.kernels import walker_pallas as wk
from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu_torch.kernels import intersect, sparse, walker
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.ops.geometry import normalize3
from pathtracerpython_tpu_torch.ops.sort import PARK_DIR, PARK_ORIGIN
from pathtracerpython_tpu_torch.scene import arrays, synthetic
from torch_parity import (
    GRAZING_MARGIN,
    T_ATOL,
    T_RTOL,
    bary_margin_f64,
    occlusion_margin_f64,
    to_jax_desc,
)


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


def _shadow_rays(n=3000, seed=0, parked=False):
    """Random shadow rays inside the field with windows of 0.5 to 8 units,
    as numpy; ``parked``: lanes 1280-2559 (the whole second block) and a
    run of the third are parked with maxd = 0, as the NEE parks them."""
    rs = np.random.default_rng(seed)
    o = rs.uniform([-8, -1, -16], [8, 1.5, 3], (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    maxd = rs.uniform(0.5, 8.0, n).astype(np.float32)
    if parked:
        for lo, hi in ((1280, 2560), (2700, 2800)):
            o[lo:hi], d[lo:hi], maxd[lo:hi] = PARK_ORIGIN, PARK_DIR, 0.0
    o3 = np.ascontiguousarray(o.T)
    d3u = normalize3(torch.from_numpy(np.ascontiguousarray(d.T))).numpy()
    return o3, d3u, maxd


def _assert_occlusion_matches(scene, o3, d3u, maxd, got, want):
    bad = np.nonzero(got != want)[0]
    assert len(bad) <= 0.01 * len(got), f"{len(bad)} mismatches"
    occ = scene.tri_occluder.numpy()
    tris = [v.numpy()[occ] for v in (scene.tri_v0, scene.tri_v1,
                                     scene.tri_v2)]
    for r in bad:
        margin = occlusion_margin_f64(*tris, o3[:, r], d3u[:, r], maxd[r])
        assert abs(margin) < GRAZING_MARGIN, (r, margin)


@pytest.mark.parametrize("parked", [False, True])
def test_walker_lists_match_walker_worklist(field, parked):
    scene, ref = field
    o3, d3u, maxd = _shadow_rays(parked=parked)
    r_blk = walker.R_BLK
    aabb8 = sparse.cluster_aabbs(sparse.pack_for_sparse(scene))
    lists = walker.walker_lists(aabb8, torch.from_numpy(o3),
                                torch.from_numpy(d3u), torch.from_numpy(maxd))
    nrb = lists.ncand.shape[0]
    jaabb8 = sp.cluster_aabbs(sp._pack_for_sparse(ref, wk.C_TRI), wk.C_TRI)
    o3p, d3p, mdp = (sp._pad_repeat_last(jnp.asarray(x), r_blk)
                     for x in (o3, d3u, maxd[None, :]))
    tmax = jnp.max(mdp.reshape(nrb, r_blk), axis=1)
    flat, offsets, jncand, overflow = wk.walker_worklist(
        jaabb8, o3p, d3p, tmax, r_blk=r_blk, w_cap=nrb * jaabb8.shape[0])
    assert not bool(overflow)
    np.testing.assert_array_equal(lists.ncand.numpy(), np.asarray(jncand))
    flat, offsets = np.asarray(flat), np.asarray(offsets)
    for b in range(nrb):
        k = int(lists.ncand[b])
        words = flat[offsets[b]:offsets[b] + k]
        assert set(lists.ids[b, :k].tolist()) == set((words & 0xFFF).tolist())
        keys = lists.keys[b, :k].numpy()
        assert (np.diff(keys) >= 0).all()
        jkeys = dict(zip((words & 0xFFF).tolist(),
                         np.asarray(wk._unpack_entry(words)).tolist()))
        for cl, key in zip(lists.ids[b, :k].tolist(), keys):
            assert key >= jkeys[cl]   # JAX truncates: a lower bound
    if parked:
        assert lists.ncand[1] == 0 and (lists.ncand[[0, 2]] > 0).all()


@pytest.mark.parametrize("parked", [False, True])
def test_plain_walker_matches_jax_kernel_and_dense(field, parked):
    scene, ref = field
    o3, d3u, maxd = _shadow_rays(seed=3, parked=parked)
    got = walker.walker_any_hit_cm(torch.from_numpy(o3),
                                   torch.from_numpy(d3u),
                                   torch.from_numpy(maxd), scene).numpy()
    assert got.dtype == np.bool_ and 0.05 < got.mean() < 0.95
    if parked:
        assert not got[1280:2560].any() and not got[2700:2800].any()
    want = np.asarray(wk.walker_any_hit_cm(
        jnp.asarray(o3), jnp.asarray(d3u), jnp.asarray(maxd), ref))
    _assert_occlusion_matches(scene, o3, d3u, maxd, got, want)
    dense = intersect.any_hit_cm(torch.from_numpy(o3), torch.from_numpy(d3u),
                                 torch.from_numpy(maxd), scene).numpy()
    np.testing.assert_array_equal(got, dense)


@pytest.mark.parametrize("case", ["all_occluded", "all_parked"])
def test_block_ends_its_walk_early(field, monkeypatch, case):
    """Two blocks of rays that start above the field and look straight down
    at the floor, with each block's list (every cluster, bound 0) led by
    the floor's clusters: every ray is occluded there, and the walk stops
    after them (all_occluded); with empty windows nothing is visited
    (all_parked). The bits equal the dense any-hit's."""
    scene, _ = field
    r_blk, n = 256, 512
    rs = np.random.default_rng(5)
    o = np.stack([rs.uniform(-7, 7, n), np.full(n, 1.2),
                  rs.uniform(-15, 0, n)]).astype(np.float32)
    o3 = torch.from_numpy(o)
    d3u = torch.tensor([0.0, -1.0, 0.0])[:, None].expand(3, n).contiguous()
    maxd = torch.full((n,), 5.0 if case == "all_occluded" else 0.0)
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    c = aabb8.shape[0]
    floor = scene.tri_valid & (scene.tri_material == 0)
    floor_cl = sorted({int(r) // sparse.C_TRI
                       for r in torch.nonzero(floor).flatten()})
    order = floor_cl + [k for k in range(c) if k not in floor_cl]
    ids = torch.tensor([order, order], dtype=torch.int32)
    lists = sparse.BlockLists(ids=ids, keys=torch.zeros(2, c),
                              ncand=torch.tensor([c, c], dtype=torch.int32))
    visits = []
    rows = sparse.cluster_rows   # the shared walk lives in kernels/sparse.py
    monkeypatch.setattr(sparse, "cluster_rows",
                        lambda pack, cl: visits.append(1) or rows(pack, cl))
    occ = walker.walker_any_hit_plain(o3, d3u, maxd, tripack, aabb8, lists,
                                      r_blk)
    dense = intersect.any_hit_cm(o3, d3u, maxd, scene)
    assert torch.equal(occ, dense)
    if case == "all_occluded":
        assert bool(occ.all()) and len(visits) == len(floor_cl) < c
    else:
        assert not bool(occ.any()) and len(visits) == 0


def test_wrapper_refuses_bad_inputs(field):
    scene, _ = field
    o3, d3 = torch.zeros(3, 8), torch.zeros(3, 8)
    with pytest.raises(ValueError, match="shape"):
        walker.walker_any_hit_cm(o3, d3, torch.zeros(7), scene)
    # a window that requires grad is no fault: occlusion is detached
    occ = walker.walker_any_hit_cm(o3, d3, torch.zeros(8, requires_grad=True),
                                   scene)
    assert not occ.requires_grad and not occ.any()


def _rays(scene, kind, n=3000, seed=0):
    """o3, d3u f32[3, n] as numpy: "random" rays inside the field (the
    incoherent case) or "primary" camera rays followed by random ones."""
    rs = np.random.default_rng(seed)
    o = rs.uniform([-8, -1, -16], [8, 1.5, 3], (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    if kind == "primary":
        po, pd = make_primary_rays(scene.eye, scene.ortho, scene.meta.width,
                                   scene.meta.height)
        o = np.concatenate([po.numpy(), o])[:n]
        d = np.concatenate([pd.numpy(), d])[:n]
    o3 = np.ascontiguousarray(o.T)
    d3u = normalize3(torch.from_numpy(np.ascontiguousarray(d.T))).numpy()
    return o3, d3u


def test_nearest_lists_match_walker_worklist(field):
    scene, ref = field
    o3, d3u = _rays(scene, "primary")
    r_blk = walker.R_BLK
    aabb8 = sparse.cluster_aabbs(sparse.pack_for_sparse(scene))
    lists = walker.nearest_lists(aabb8, torch.from_numpy(o3),
                                 torch.from_numpy(d3u))
    nrb = lists.ncand.shape[0]
    assert nrb == 3
    jaabb8 = sp.cluster_aabbs(sp._pack_for_sparse(ref, wk.C_TRI), wk.C_TRI)
    o3p, d3p = (sp._pad_repeat_last(jnp.asarray(x), r_blk)
                for x in (o3, d3u))
    flat, offsets, jncand, overflow = wk.walker_worklist(
        jaabb8, o3p, d3p, jnp.full((nrb,), intersect.BIG, jnp.float32),
        r_blk=r_blk, w_cap=nrb * jaabb8.shape[0])
    assert not bool(overflow)
    np.testing.assert_array_equal(lists.ncand.numpy(), np.asarray(jncand))
    flat, offsets = np.asarray(flat), np.asarray(offsets)
    for b in range(nrb):
        k = int(lists.ncand[b])
        words = flat[offsets[b]:offsets[b] + k]
        assert set(lists.ids[b, :k].tolist()) == set((words & 0xFFF).tolist())
        assert (np.diff(lists.keys[b, :k].numpy()) >= 0).all()


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


@pytest.mark.parametrize("kind", ["random", "primary"])
def test_plain_walker_nearest_matches_jax_kernel_dense_and_sparse(field,
                                                                  kind):
    scene, ref = field
    o3, d3u = _rays(scene, kind)
    rays = [torch.from_numpy(o3), torch.from_numpy(d3u)]
    t, idx = (x.numpy() for x in walker.walker_nearest_t_idx_cm(*rays, scene))
    assert idx.dtype == np.int32 and t.dtype == np.float32
    assert (idx >= 0).mean() > 0.1 and (idx < 0).any()
    jt, jidx = map(np.asarray, wk.walker_nearest_t_idx_cm(
        jnp.asarray(o3), jnp.asarray(d3u), ref))
    _assert_winners_match(scene, o3, d3u, t, idx, jt, jidx)
    for other in (intersect.nearest_t_idx_cm,        # dense K1
                  sparse.sparse_nearest_t_idx_cm):   # plain K5, blocks of 512
        ot, oidx = other(*rays, scene)
        np.testing.assert_array_equal(idx, oidx.numpy())
        np.testing.assert_array_equal(t, ot.numpy())


def test_walker_nearest_shared_edge_ties(field):
    """Rays aimed exactly at box-corner vertices: equal-t hits on several
    triangles and u, v = 0 boundary hits. The walk visits clusters front to
    back, the dense sweep in index order; the (t, index) merge makes the
    winner the same."""
    scene, _ = field
    v = scene.tri_v0[:512]
    o = torch.tensor([0.0, 0.0, 3.0])
    d3u = normalize3((v - o).T.contiguous()).contiguous()
    o3 = o[:, None].expand(3, 512).contiguous()
    t, idx = walker.walker_nearest_t_idx_cm(o3, d3u, scene)
    dt, didx = intersect.nearest_t_idx_cm(o3, d3u, scene)
    assert torch.equal(idx, didx) and torch.equal(t, dt)
    assert (idx >= 0).float().mean() > 0.5


def test_walker_nearest_duplicate_triangle_tie(field):
    """An interior triangle duplicated at a higher index in a far cluster,
    rays at its centre: both copies give the same t, and the lower index
    wins whichever cluster the walk visits first."""
    scene, _ = field
    src, dst = 37, scene.num_padded_triangles - 5
    rep = {}
    for f in ("tri_v0", "tri_v1", "tri_v2", "tri_normal"):
        buf = getattr(scene, f).clone()
        buf[dst] = buf[src]
        rep[f] = buf
    for f in ("tri_valid", "tri_occluder"):
        buf = getattr(scene, f).clone()
        buf[dst] = True
        rep[f] = buf
    dup = dataclasses.replace(scene, **rep)
    center = ((dup.tri_v0[src] + dup.tri_v1[src] + dup.tri_v2[src])
              / 3.0).numpy()
    n = 512
    rs = np.random.default_rng(11)
    o = (center + np.asarray([0.0, 0.0, 2.5])
         + rs.normal(scale=1e-3, size=(n, 3))).astype(np.float32)
    d3u = normalize3(torch.from_numpy(
        (center[None] - o).T.astype(np.float32))).contiguous()
    o3 = torch.from_numpy(np.ascontiguousarray(o.T))
    t, idx = walker.walker_nearest_t_idx_cm(o3, d3u, dup)
    dt, didx = intersect.nearest_t_idx_cm(o3, d3u, dup)
    hits = torch.isin(didx, torch.tensor([src, dst], dtype=torch.int32))
    assert int(hits.sum()) > n // 4
    assert not bool((idx[hits] == dst).any())
    assert torch.equal(idx, didx) and torch.equal(t, dt)


def test_walker_nearest_block_stops_early(field, monkeypatch):
    """Rays that look straight down from above the field and see the floor
    between the boxes, with each block's list (every cluster) led by the
    floor's clusters at bound 0 and the others at a bound past the floor:
    the walk ends after the floor's clusters, and the winners are the dense
    sweep's."""
    scene, _ = field
    r_blk, n = 256, 512
    rs = np.random.default_rng(5)
    o = np.stack([rs.uniform(-7, 7, 4 * n), np.full(4 * n, 1.2),
                  rs.uniform(-15, 0, 4 * n)]).astype(np.float32)
    o3 = torch.from_numpy(o)
    d3u = torch.tensor([0.0, -1.0, 0.0])[:, None].expand(3, 4 * n).contiguous()
    floor = scene.tri_valid & (scene.tri_material == 0)
    _, didx = intersect.nearest_t_idx_cm(o3, d3u, scene)
    sees_floor = torch.nonzero(floor[didx.to(torch.int64)]
                               & (didx >= 0)).flatten()[:n]
    assert sees_floor.shape[0] == n
    o3 = o3[:, sees_floor].contiguous()
    d3u = d3u[:, :n].contiguous()
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    c = aabb8.shape[0]
    dt, didx = intersect.nearest_t_idx_cm(o3, d3u, scene)
    floor_cl = sorted({int(r) // sparse.C_TRI
                       for r in torch.nonzero(floor).flatten()})
    order = floor_cl + [k for k in range(c) if k not in floor_cl]
    keys = torch.tensor([0.0] * len(floor_cl)
                        + [float(dt.max()) + 1.0] * (c - len(floor_cl)))
    lists = sparse.BlockLists(
        ids=torch.tensor([order, order], dtype=torch.int32),
        keys=torch.stack([keys, keys]),
        ncand=torch.tensor([c, c], dtype=torch.int32))
    visits = []
    rows = sparse.cluster_rows
    monkeypatch.setattr(sparse, "cluster_rows",
                        lambda pack, cl: visits.append(1) or rows(pack, cl))
    t, idx = walker.walker_nearest_plain(o3, d3u, tripack, aabb8, lists,
                                         r_blk)
    assert torch.equal(idx, didx) and torch.equal(t, dt)
    assert len(visits) == len(floor_cl) < c


def test_nearest_wrapper_refuses_bad_inputs(field):
    scene, _ = field
    d3 = torch.zeros(3, 8)
    # rays that require grad are no fault since K8 carries its gradient
    t, idx = walker.walker_nearest_t_idx_cm(
        torch.zeros(3, 8, requires_grad=True), d3, scene)
    assert t.requires_grad and not idx.requires_grad
    with pytest.raises(ValueError, match="shape"):
        walker.walker_nearest_t_idx_cm(torch.zeros(3, 8), d3[:, :4], scene)
    with pytest.raises(ValueError, match="contiguous"):
        walker.walker_nearest_t_idx_cm(torch.zeros(8, 3).T, d3, scene)
    t, idx = walker.walker_nearest_t_idx_cm(torch.zeros(3, 0),
                                            torch.zeros(3, 0), scene)
    assert t.shape == idx.shape == (0,)
