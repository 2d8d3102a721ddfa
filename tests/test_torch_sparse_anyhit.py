"""K6, the cluster-sparse shadow any-hit (``kernels/sparse.py``), against the
JAX package's ``kernels/sparse_pallas.py``: its list construction called
directly, and its Pallas kernel in interpret mode on the CPU, as
tests/test_sparse.py runs it; and against the port's dense any-hit K4 and
walker any-hit K9.

Tolerances: the lists are compared as sets per block (clusters of equal
entry bound may come in either order, and no occlusion bit depends on the
order). Occlusion bits are equal to JAX's except on grazing rays: a
mismatch must sit within 1e-5 (float64) of flipping against some occluder.
Within the port K6, K4 and K9 are equal on every lane."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.kernels import sparse_pallas as sp
from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu_torch.kernels import intersect, sparse, walker
from pathtracerpython_tpu_torch.ops.geometry import normalize3
from pathtracerpython_tpu_torch.ops.sort import PARK_DIR, PARK_ORIGIN
from pathtracerpython_tpu_torch.scene import arrays, synthetic
from torch_parity import (
    GRAZING_MARGIN,
    decode_grouped,
    occlusion_margin_f64,
    to_jax_desc,
)

R_BLK = sparse.R_BLK


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


def _shadow_rays(n=1400, seed=0, parked=False):
    """Random shadow rays inside the field with windows of 0.5 to 8 units,
    as numpy; ``parked``: lanes 512-1023 (the whole second block) and a run
    of the third are parked with maxd = 0, as the NEE parks them."""
    rs = np.random.default_rng(seed)
    o = rs.uniform([-8, -1, -16], [8, 1.5, 3], (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    maxd = rs.uniform(0.5, 8.0, n).astype(np.float32)
    if parked:
        for lo, hi in ((512, 1024), (1100, 1200)):
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
def test_window_lists_match_grouped_worklist(field, parked):
    """Blocks of 512 with the block's largest window as the distance limit:
    the candidate sets of ``grouped_worklist``."""
    scene, ref = field
    o3, d3u, maxd = _shadow_rays(parked=parked)
    aabb8 = sparse.cluster_aabbs(sparse.pack_for_sparse(scene))
    lists = sparse.window_lists(aabb8, torch.from_numpy(o3),
                                torch.from_numpy(d3u),
                                torch.from_numpy(maxd), R_BLK)
    nrb = lists.ncand.shape[0]
    assert nrb == 3 and lists.ids.shape == (3, 8)
    jaabb8 = sp.cluster_aabbs(sp._pack_for_sparse(ref, sp.C_TRI), sp.C_TRI)
    o3p, d3p, mdp = (sp._pad_repeat_last(jnp.asarray(x), R_BLK)
                     for x in (o3, d3u, maxd[None, :]))
    tmax = jnp.max(mdp.reshape(nrb, R_BLK), axis=1)
    packs, jncand, overflow = sp.grouped_worklist(
        jaabb8, o3p, d3p, tmax, r_blk=R_BLK, maxc=sp.MAXC,
        w_cap=nrb * jaabb8.shape[0], group=2, maxd_lanes=mdp[0])
    assert not bool(overflow)
    np.testing.assert_array_equal(lists.ncand.numpy(), np.asarray(jncand))
    want = decode_grouped(packs, nrb)
    for b in range(nrb):
        k = int(lists.ncand[b])
        ids = lists.ids[b, :k].tolist()
        assert set(ids) == want[b] and len(ids) == k
        keys = lists.keys[b, :k]
        assert bool((keys[1:] >= keys[:-1]).all())   # front to back
    if parked:
        assert lists.ncand[1] == 0 and (lists.ncand[[0, 2]] > 0).all()


@pytest.mark.parametrize("parked", [False, True])
def test_plain_sparse_any_hit_matches_jax_kernel_and_dense(field, parked):
    scene, ref = field
    o3, d3u, maxd = _shadow_rays(seed=3, parked=parked)
    rays = [torch.from_numpy(x) for x in (o3, d3u, maxd)]
    got = sparse.sparse_any_hit_cm(*rays, scene).numpy()
    assert got.dtype == np.bool_ and 0.05 < got.mean() < 0.95
    if parked:
        assert not got[512:1024].any() and not got[1100:1200].any()
    want = np.asarray(sp.sparse_any_hit_cm(
        jnp.asarray(o3), jnp.asarray(d3u), jnp.asarray(maxd), ref))
    _assert_occlusion_matches(scene, o3, d3u, maxd, got, want)
    dense = intersect.any_hit_cm(*rays, scene).numpy()
    np.testing.assert_array_equal(got, dense)
    walked = walker.walker_any_hit_cm(*rays, scene).numpy()
    np.testing.assert_array_equal(got, walked)


@pytest.mark.parametrize("case", ["all_occluded", "all_parked"])
def test_block_of_occluded_or_parked_lanes(field, monkeypatch, case):
    """Two blocks of rays that start above the field and look straight down
    at the floor, with each block's list (every cluster, bound 0) led by
    the floor's clusters: every ray is occluded there and no later cluster
    is visited (all_occluded); with empty windows nothing is visited
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
    rows = sparse.cluster_rows
    monkeypatch.setattr(sparse, "cluster_rows",
                        lambda pack, cl: visits.append(1) or rows(pack, cl))
    occ = sparse.sparse_any_hit_plain(o3, d3u, maxd, tripack, aabb8, lists,
                                      r_blk)
    dense = intersect.any_hit_cm(o3, d3u, maxd, scene)
    assert torch.equal(occ, dense)
    if case == "all_occluded":
        assert bool(occ.all()) and len(visits) == len(floor_cl) < c
    else:
        assert not bool(occ.any()) and len(visits) == 0


def test_gate_counts_the_visits(field):
    """``visits`` receives the (ray, cluster) pairs the per-lane gate lets
    through: at most lanes x candidates, and none for parked lanes."""
    scene, _ = field
    o3, d3u, maxd = (torch.from_numpy(x) for x in _shadow_rays(parked=True))
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    lists = sparse.window_lists(aabb8, o3, d3u, maxd, R_BLK)
    visits = []
    sparse.sparse_any_hit_plain(o3, d3u, maxd, tripack, aabb8, lists, R_BLK,
                                visits)
    total = int(torch.stack(visits).sum())
    assert 0 < total <= int((lists.ncand * R_BLK).sum())
    parked = [torch.from_numpy(x[..., 512:1024].copy())
              for x in _shadow_rays(parked=True)]
    visits = []
    sparse.sparse_any_hit_plain(
        *parked, tripack, aabb8,
        sparse.window_lists(aabb8, *parked, R_BLK), R_BLK, visits)
    assert visits == []


def test_wrapper_refuses_bad_inputs(field):
    scene, _ = field
    o3, d3 = torch.zeros(3, 8), torch.zeros(3, 8)
    with pytest.raises(ValueError, match="shape"):
        sparse.sparse_any_hit_cm(o3, d3, torch.zeros(7), scene)
    # a window that requires grad is no fault: occlusion is detached
    occ = sparse.sparse_any_hit_cm(o3, d3, torch.zeros(8, requires_grad=True),
                                   scene)
    assert not occ.requires_grad and not occ.any()
    with pytest.raises(TypeError, match="dtype"):
        sparse.sparse_any_hit_cm(o3.double(), d3, torch.zeros(8), scene)
    assert sparse.sparse_any_hit_cm(torch.zeros(3, 0), torch.zeros(3, 0),
                                    torch.zeros(0), scene).shape == (0,)
