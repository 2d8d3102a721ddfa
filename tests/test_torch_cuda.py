"""The CUDA kernels on the card against their plain versions, and the render
on the card against the same render on the CPU. These need an NVIDIA GPU
with nvcc (the library is built for sm_90a) and skip elsewhere. On the
card, from the root of a checkout:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Since the gradient slice it also holds the gradients on the card against
the CPU's, the autograd Functions' forward bits against the no-grad calls,
and the hierarchies' sweep gradients against the dense sweep's.

``--noconftest`` because ``tests/conftest.py`` sets up JAX, which a machine
that runs only the port need not have; this file imports no JAX.

Tolerances: kernel and plain version run the same float32 operations in
the same order (the library is built with -fmad=false), so they agree bit
for bit except where the card's rsqrt or a grazing ray flips a discrete
choice; the bounds below leave room for that and nothing more."""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracerpython_tpu_torch.kernels import (
    build,
    intersect,
    nee,
    sparse,
    walker,
)
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.ops.geometry import nearest_hit_cm, normalize3
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import (
    arrival_side_normal,
    render,
)
from pathtracerpython_tpu_torch.scene import arrays, synthetic

pytestmark = pytest.mark.cuda

MIN_AGREE = 0.999         # share of lanes with the same winner / bits
T_RTOL = T_ATOL = 1e-6    # K1 t on lanes with the same winner
MC_ATOL = 1e-5            # K2 mean cosine on lanes whose bits agree
RENDER_TOL = 1e-4         # card against CPU radiance, on 99% of pixels


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: with one intra-op thread these tests take
    the same time alone and do not fight the other test workers for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CPU runs the plain versions")
    return torch.device("cuda")


def _scene(name, cuda):
    if name == "cornell":
        desc, pad_to = synthetic.cornell_box_scene(40, 40), 32
    elif name == "boxfield300":  # 3604 triangles, 15 shared-memory tiles
        desc, pad_to = synthetic.box_field_scene(n_boxes=300, width=40,
                                                 height=40), 128
    else:  # 2000 boxes: 24,004 triangles in 188 clusters, morton order
        return arrays.pack_scene(synthetic.box_field_scene(
            n_boxes=2000, width=40, height=40), tri_order="morton",
            device=cuda)
    return arrays.pack_scene(desc, pad_to=pad_to, device=cuda)


def _rays(scene, seed=0):
    """Primary rays and random rays from inside the scene, on its device;
    1600 + 999 lanes, so the last block of 256 is ragged."""
    rs = np.random.default_rng(seed)
    o, d = make_primary_rays(scene.eye, scene.ortho, scene.meta.width,
                             scene.meta.height)
    valid = scene.tri_valid.cpu().numpy()
    verts = scene.tri_v0.cpu().numpy()[valid]
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    o_rand = torch.from_numpy(rs.uniform(lo, hi, (999, 3)).astype(np.float32))
    d_rand = torch.from_numpy(rs.normal(size=(999, 3)).astype(np.float32))
    o3 = torch.cat([o.T, o_rand.T.to(scene.device)], 1).contiguous()
    d3 = torch.cat([d.T, d_rand.T.to(scene.device)], 1).contiguous()
    return o3, normalize3(d3).contiguous()


@pytest.mark.parametrize("name", ["cornell", "boxfield300"])
def test_nearest_kernel_matches_plain(cuda, name):
    scene = _scene(name, cuda)
    o3, d3u = _rays(scene)
    before = intersect.LAUNCHES
    t, idx = intersect.nearest_t_idx_cm(o3, d3u, scene)
    assert intersect.LAUNCHES == before + 1
    pt, pidx = intersect.nearest_t_idx_plain(o3, d3u,
                                             intersect.scene_tripack(scene))
    torch.cuda.synchronize()
    assert t.device.type == "cuda" and idx.dtype == torch.int32
    assert bool((t[idx < 0] == 0).all())
    same = idx == pidx
    assert same.float().mean().item() >= MIN_AGREE
    torch.testing.assert_close(t[same], pt[same], rtol=T_RTOL, atol=T_ATOL)


@pytest.mark.parametrize("s_samples", [1, 3, 8])
@pytest.mark.parametrize("name", ["cornell", "boxfield300"])
def test_nee_kernel_matches_plain(cuda, name, s_samples):
    scene = _scene(name, cuda)
    o3, d3u = _rays(scene)
    hit = nearest_hit_cm(o3, d3u, scene)
    normal3 = arrival_side_normal(hit.normal3, d3u).contiguous()
    point3 = hit.point3.contiguous()
    n = point3.shape[1]
    u = torch.from_numpy(np.random.default_rng(s_samples).uniform(
        size=(5 * s_samples, n)).astype(np.float32)).to(cuda)
    before = nee.LAUNCHES
    mc, occ = nee.nee_mean_cos_fused(point3, normal3, u, scene, s_samples)
    assert nee.LAUNCHES == before + 1
    pmc, pocc = nee.nee_mean_cos_plain(point3, normal3, u,
                                       intersect.scene_tripack(scene),
                                       nee.light_pack(scene), s_samples)
    torch.cuda.synchronize()
    assert mc.shape == (1, n) and occ.shape == (s_samples, n)
    same = occ == pocc
    assert same.float().mean().item() >= MIN_AGREE
    lanes = same.all(dim=0)
    torch.testing.assert_close(mc[0][lanes], pmc[0][lanes], rtol=0,
                               atol=MC_ATOL)


def test_render_on_card_matches_cpu(cuda):
    scene = arrays.pack_scene(synthetic.cornell_box_scene(16, 16), pad_to=32,
                              device="cpu")
    cfg = RenderConfig(n_samples=2, n_bounces=3, batch_samples=True)
    k1, k2 = intersect.LAUNCHES, nee.LAUNCHES
    on_card = render(scene.to(cuda), cfg, seed=5)
    assert intersect.LAUNCHES == k1 + 3 and nee.LAUNCHES == k2 + 3
    assert on_card.device.type == "cuda"
    on_cpu = render(scene, cfg, seed=5)
    close = torch.isclose(on_card.cpu(), on_cpu, rtol=RENDER_TOL,
                          atol=RENDER_TOL).all(dim=1)
    assert close.float().mean().item() >= 0.99
    looped = render(scene.to(cuda), dataclasses.replace(
        cfg, batch_samples=False), seed=5)
    assert torch.equal(looped, on_card)


def test_failed_build_raises_on_the_card(cuda, tmp_path, monkeypatch):
    """A CUDA tensor never falls back to the plain version."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "find_nvcc", lambda: "false")
    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_functions", {})
    scene = _scene("cornell", cuda)
    o3, d3u = _rays(scene)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        intersect.nearest_t_idx_cm(o3, d3u, scene)


def _shadow_rays(scene, seed=1):
    """Rays of ``_rays`` with windows of 0 to 12 units; every tenth lane is
    parked (maxd = 0, as the NEE parks irrelevant lanes)."""
    o3, d3u = _rays(scene, seed)
    rs = np.random.default_rng(seed)
    maxd = torch.from_numpy(rs.uniform(0.0, 12.0, o3.shape[1]).astype(
        np.float32)).to(o3.device)
    maxd[::10] = 0.0
    return o3, d3u, maxd


@pytest.mark.parametrize("name", ["cornell", "boxfield300"])
def test_any_hit_kernel_matches_plain(cuda, name):
    scene = _scene(name, cuda)
    o3, d3u, maxd = _shadow_rays(scene)
    before = intersect.ANY_HIT_LAUNCHES
    occ = intersect.any_hit_cm(o3, d3u, maxd, scene)
    assert intersect.ANY_HIT_LAUNCHES == before + 1
    plain = intersect.any_hit_plain(o3, d3u, maxd,
                                    intersect.scene_tripack(scene))
    torch.cuda.synchronize()
    assert occ.dtype == torch.bool and occ.device.type == "cuda"
    assert not bool(occ[::10].any())
    assert torch.equal(occ, plain)
    assert 0.05 < occ.float().mean().item() < 0.95


def test_sparse_nearest_kernel_matches_plain_and_dense(cuda):
    scene = _scene("boxfield2000", cuda)
    o3, d3u = _rays(scene)
    before = sparse.LAUNCHES
    r_blk = sparse.R_BLK_HYBRID_NEAREST
    t, idx = sparse.sparse_nearest_t_idx_cm(o3, d3u, scene, r_blk=r_blk)
    assert sparse.LAUNCHES == before + 1
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    nrb = -(-o3.shape[1] // r_blk)
    lists = sparse.block_lists(aabb8, o3, d3u, torch.full(
        (nrb,), intersect.BIG, device=cuda), r_blk)
    pt, pidx = sparse.sparse_nearest_plain(o3, d3u, tripack, aabb8, lists,
                                           r_blk)
    dt, didx = intersect.nearest_t_idx_cm(o3, d3u, scene)
    torch.cuda.synchronize()
    assert bool((t[idx < 0] == 0).all()) and (idx >= 0).any()
    for want_t, want_idx in ((pt, pidx), (dt, didx)):
        same = idx == want_idx
        assert same.float().mean().item() >= MIN_AGREE
        torch.testing.assert_close(t[same], want_t[same], rtol=T_RTOL,
                                   atol=T_ATOL)


def test_walker_any_hit_kernel_matches_plain_and_dense(cuda):
    scene = _scene("boxfield2000", cuda)
    o3, d3u, maxd = _shadow_rays(scene)
    before = walker.LAUNCHES
    occ = walker.walker_any_hit_cm(o3, d3u, maxd, scene)
    assert walker.LAUNCHES == before + 1
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    lists = walker.walker_lists(aabb8, o3, d3u, maxd)
    plain = walker.walker_any_hit_plain(o3, d3u, maxd, tripack, aabb8, lists,
                                        walker.R_BLK)
    dense = intersect.any_hit_cm(o3, d3u, maxd, scene)
    torch.cuda.synchronize()
    assert not bool(occ[::10].any())
    assert (occ == plain).float().mean().item() >= MIN_AGREE
    assert (occ == dense).float().mean().item() >= MIN_AGREE
    assert 0.05 < occ.float().mean().item() < 0.95


def _launch_counts():
    return {"K5": sparse.LAUNCHES, "K6": sparse.ANY_HIT_LAUNCHES,
            "K7": sparse.ANY_HIT_IDX_LAUNCHES, "K8": walker.NEAREST_LAUNCHES,
            "K9": walker.LAUNCHES}


@pytest.mark.parametrize("options,launches", [
    (dict(), dict(K5=3, K9=3)),                      # "auto": the hybrid
    (dict(accel="sparse"), dict(K5=3, K6=3)),
    (dict(accel="sparse", nee_cache="on"), dict(K5=3, K7=6)),
    (dict(accel="walker"), dict(K8=3, K9=3)),
])
def test_hierarchy_render_on_card_matches_cpu(cuda, options, launches):
    scene = arrays.pack_scene(synthetic.box_field_scene(
        n_boxes=400, width=16, height=16), tri_order="morton", device="cpu")
    cfg = RenderConfig(n_samples=2, n_bounces=3, batch_samples=True,
                       **options)
    before = _launch_counts()
    on_card = render(scene.to(cuda), cfg, seed=5)
    after = _launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        **dict.fromkeys(after, 0), **launches}
    on_cpu = render(scene, cfg, seed=5)
    close = torch.isclose(on_card.cpu(), on_cpu, rtol=RENDER_TOL,
                          atol=RENDER_TOL).all(dim=1)
    assert close.float().mean().item() >= 0.99


def test_pack_scene_builds_on_the_card_by_default(cuda):
    scene = arrays.pack_scene(synthetic.cornell_box_scene(8, 8), pad_to=32)
    assert scene.device.type == "cuda"


def test_walker_nearest_kernel_matches_plain_dense_and_sparse(cuda):
    scene = _scene("boxfield2000", cuda)
    o3, d3u = _rays(scene)
    before = walker.NEAREST_LAUNCHES
    t, idx = walker.walker_nearest_t_idx_cm(o3, d3u, scene)
    assert walker.NEAREST_LAUNCHES == before + 1
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    lists = walker.nearest_lists(aabb8, o3, d3u)
    plain = walker.walker_nearest_plain(o3, d3u, tripack, aabb8, lists,
                                        walker.R_BLK)
    dense = intersect.nearest_t_idx_cm(o3, d3u, scene)
    sparse5 = sparse.sparse_nearest_t_idx_cm(o3, d3u, scene)
    torch.cuda.synchronize()
    assert bool((t[idx < 0] == 0).all()) and (idx >= 0).any()
    for want_t, want_idx in (plain, dense, sparse5):
        same = idx == want_idx
        assert same.float().mean().item() >= MIN_AGREE
        torch.testing.assert_close(t[same], want_t[same], rtol=T_RTOL,
                                   atol=T_ATOL)


def test_sparse_any_hit_kernel_matches_plain_dense_and_walker(cuda):
    scene = _scene("boxfield2000", cuda)
    o3, d3u, maxd = _shadow_rays(scene)
    before = sparse.ANY_HIT_LAUNCHES
    occ = sparse.sparse_any_hit_cm(o3, d3u, maxd, scene)
    assert sparse.ANY_HIT_LAUNCHES == before + 1
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    lists = sparse.window_lists(aabb8, o3, d3u, maxd, sparse.R_BLK)
    plain = sparse.sparse_any_hit_plain(o3, d3u, maxd, tripack, aabb8, lists,
                                        sparse.R_BLK)
    dense = intersect.any_hit_cm(o3, d3u, maxd, scene)
    walked = walker.walker_any_hit_cm(o3, d3u, maxd, scene)
    torch.cuda.synchronize()
    assert not bool(occ[::10].any())
    for want in (plain, dense, walked):
        assert (occ == want).float().mean().item() >= MIN_AGREE
    assert 0.05 < occ.float().mean().item() < 0.95


def test_cached_any_hit_kernel_matches_plain_and_uncached(cuda):
    """K7 against its culled model and its plain version on the full lists
    and on the guess lists of the cache it returned: bits and blocking
    clusters, the same in two runs; its two passes against K6 for a cold, a
    returned and a random cache."""
    scene = _scene("boxfield2000", cuda)
    o3, d3u, maxd = _shadow_rays(scene)
    n = o3.shape[1]
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    want = sparse.sparse_any_hit_cm(o3, d3u, maxd, scene)
    cold = torch.full((n,), -1, dtype=torch.int32, device=cuda)
    before = sparse.ANY_HIT_IDX_LAUNCHES
    occ, cl = sparse.sparse_any_hit_cached_cm(o3, d3u, maxd, scene, cold)
    assert sparse.ANY_HIT_IDX_LAUNCHES == before + 2   # pass 1 and pass 2
    assert torch.equal(occ, want) and torch.equal(cl >= 0, occ)
    rs = np.random.default_rng(3)
    garbage = torch.from_numpy(rs.integers(-3, 3 * aabb8.shape[0], n).astype(
        np.int32)).to(cuda)
    for guess in (cl, garbage):
        occ2, cl2 = sparse.sparse_any_hit_cached_cm(o3, d3u, maxd, scene,
                                                    guess)
        assert torch.equal(occ2, want) and torch.equal(cl2 >= 0, occ2)
    cull = sparse.scene_cluster_cull_boxes(scene)
    for lists in (sparse.window_lists(aabb8, o3, d3u, maxd, sparse.R_BLK),
                  sparse.guess_lists(cl, aabb8.shape[0])):
        args = (o3, d3u, maxd, tripack, aabb8, lists, sparse.R_BLK)
        k_occ, k_cl = sparse._launch_any_hit_idx(*args, cull)
        again = sparse._launch_any_hit_idx(*args, cull)
        p_occ, p_cl = sparse.sparse_any_hit_idx_plain(*args)
        m_occ, m_cl = sparse.any_hit_walk(*args, cull=cull,
                                          merge="first_slot")
        torch.cuda.synchronize()
        assert torch.equal(k_occ, again[0]) and torch.equal(k_cl, again[1])
        assert torch.equal(k_occ, m_occ) and torch.equal(k_cl, m_cl)
        assert (k_occ == p_occ).float().mean().item() >= MIN_AGREE
        assert (k_cl == p_cl).float().mean().item() >= MIN_AGREE


@pytest.mark.parametrize("which", ["full", "guess"])
@pytest.mark.parametrize("scene_name", ["large", "cornell"])
def test_cached_any_hit_kernel_equals_culled_model(cuda, scene_name, which):
    """K7 on the full lists (of many segments on the 2000-box field, of one
    on the Cornell stand-in) and on the guess lists of a cold call's cache:
    bits and first blocking clusters equal to its culled model's on every
    lane, the counting instance's too, its units those the lists give, its
    counts inside their band, and its bits K6's."""
    scene = _scene(scene_name, cuda)
    o3, d3u, maxd = _shadow_rays(scene)
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    cull = sparse.scene_cluster_cull_boxes(scene)
    if which == "full":
        lists = sparse.window_lists(aabb8, o3, d3u, maxd, sparse.R_BLK)
    else:
        cold = torch.full((o3.shape[1],), -1, dtype=torch.int32, device=cuda)
        cache = sparse.sparse_any_hit_cached_cm(o3, d3u, maxd, scene, cold)[1]
        lists = sparse.guess_lists(cache, aabb8.shape[0])
    args = (o3, d3u, maxd, tripack, aabb8, lists, sparse.R_BLK)
    counts = {}
    m_occ, m_cl = sparse.any_hit_walk(*args, cull=cull, counts=counts,
                                      merge="first_slot")
    stats = torch.zeros(len(sparse.ANY_HIT_COUNTS), dtype=torch.int64,
                        device=cuda)
    c_occ, c_cl = sparse._launch_any_hit_idx(*args, cull, stats)
    occ, cl = sparse._launch_any_hit_idx(*args, cull)
    torch.cuda.synchronize()
    assert bool(occ.any()) and not bool(occ.all())
    for got_occ, got_cl in ((occ, cl), (c_occ, c_cl)):
        assert torch.equal(got_occ, m_occ) and torch.equal(got_cl, m_cl)
    if which == "full":
        assert torch.equal(occ, sparse._launch_any_hit(*args, cull))
    got = sparse.any_hit_stats(stats)
    assert got["units_launched"] == sparse.walk_units(
        lists, sparse.R_BLK, sparse.ANY_HIT_SEGMENT)
    band = sparse.any_hit_visit_band(*args, m_occ, sparse.ANY_HIT_SEGMENT,
                                     intersect.CLASSIC, cull)
    for key, (floor, ceiling) in band.items():
        assert floor <= got[key] <= ceiling, (key, got[key], floor, ceiling)
    if int(lists.ncand.max()) <= sparse.ANY_HIT_SEGMENT:
        # one unit a block slice: the serial walk, count for count
        assert {k: got[k] for k in counts} == counts


def test_cached_any_hit_entry_refuses_null_boxes(cuda):
    """cudaErrorInvalidValue (1) without the cluster boxes."""
    scene = _scene("large", cuda)
    o3, d3u, maxd = _shadow_rays(scene)
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    lists = sparse.window_lists(aabb8, o3, d3u, maxd, sparse.R_BLK)
    fn = build.function("ptt_sparse_any_hit_idx",
                        sparse._ANY_HIT_IDX_ARGTYPES)
    n = o3.shape[1]
    first = torch.full((n,), intersect.IMAX, dtype=torch.int32, device=cuda)
    occ = torch.empty(n, dtype=torch.bool, device=cuda)
    cl = torch.empty(n, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert fn(o3.data_ptr(), d3u.data_ptr(), maxd.data_ptr(), n,
              tripack.data_ptr(), aabb8.data_ptr(), None,
              lists.ids.data_ptr(), lists.keys.data_ptr(),
              lists.ncand.data_ptr(), lists.ids.shape[1], sparse.R_BLK,
              first.data_ptr(), occ.data_ptr(), cl.data_ptr(), None,
              cuda.index or 0, stream) == 1


# K3, the Plücker form, and the probes P1 and P2.


@pytest.mark.parametrize("name", ["cornell", "boxfield300"])
def test_plucker_nearest_kernel_matches_plain(cuda, name):
    scene = _scene(name, cuda)
    o3, d3u = _rays(scene)
    before, classic = intersect.PLUCKER_LAUNCHES, intersect.LAUNCHES
    t, idx = intersect.nearest_t_idx_cm(o3, d3u, scene, mt_impl="plucker")
    assert intersect.PLUCKER_LAUNCHES == before + 1
    assert intersect.LAUNCHES == classic
    pt, pidx = intersect.nearest_t_idx_plucker_plain(
        o3, d3u, intersect.scene_plucker_pack(scene))
    torch.cuda.synchronize()
    assert bool((t[idx < 0] == 0).all()) and bool((idx >= 0).any())
    same = idx == pidx
    assert same.float().mean().item() >= MIN_AGREE
    torch.testing.assert_close(t[same], pt[same], rtol=T_RTOL, atol=T_ATOL)
    # the classic form's winners but for grazing rays
    _, cidx = intersect.nearest_t_idx_cm(o3, d3u, scene)
    assert (idx == cidx).float().mean().item() >= 1.0 - 2e-3


def test_plucker_any_hit_kernel_matches_plain(cuda):
    scene = _scene("boxfield300", cuda)
    o3, d3u = _rays(scene)
    maxd = torch.full((o3.shape[1],), 6.0, device=cuda)
    maxd[::7] = 0.0  # parked lanes
    before = intersect.PLUCKER_ANY_HIT_LAUNCHES
    occ = intersect.any_hit_cm(o3, d3u, maxd, scene, mt_impl="plucker")
    assert intersect.PLUCKER_ANY_HIT_LAUNCHES == before + 1
    plain = intersect.any_hit_plucker_plain(
        o3, d3u, maxd, intersect.scene_plucker_pack(scene))
    torch.cuda.synchronize()
    assert occ.dtype == torch.bool and bool(occ.any())
    assert not bool(occ[::7].any())
    assert (occ == plain).float().mean().item() >= MIN_AGREE
    classic = intersect.any_hit_cm(o3, d3u, maxd, scene)
    assert (occ == classic).float().mean().item() >= 1.0 - 2e-3


@pytest.mark.parametrize("r_blk", [512, 1024])
def test_plucker_sparse_nearest_kernel(cuda, r_blk):
    scene = _scene("large", cuda)
    o3, d3u = _rays(scene)
    before = sparse.PLUCKER_LAUNCHES
    t, idx = sparse.sparse_nearest_t_idx_cm(o3, d3u, scene, r_blk=r_blk,
                                            mt_impl="plucker")
    assert sparse.PLUCKER_LAUNCHES == before + 1
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    nrb = -(-o3.shape[1] // r_blk)
    lists = sparse.block_lists(aabb8, o3, d3u, torch.full(
        (nrb,), intersect.BIG, device=cuda), r_blk)
    pt, pidx = sparse.sparse_nearest_plucker_plain(
        o3, d3u, intersect.scene_plucker_pack(scene, sparse.PACK_ROWS), aabb8,
        lists, r_blk)
    td, idxd = intersect.nearest_t_idx_cm(o3, d3u, scene, mt_impl="plucker")
    torch.cuda.synchronize()
    assert (idx == pidx).float().mean().item() >= MIN_AGREE
    # the dense Plücker sweep's bits
    assert torch.equal(idx, idxd) and torch.equal(t, td)


def test_plucker_sparse_any_hit_kernel(cuda):
    scene = _scene("large", cuda)
    o3, d3u = _rays(scene)
    maxd = torch.full((o3.shape[1],), 8.0, device=cuda)
    maxd[::5] = 0.0
    before = sparse.PLUCKER_ANY_HIT_LAUNCHES
    occ = sparse.sparse_any_hit_cm(o3, d3u, maxd, scene, mt_impl="plucker")
    assert sparse.PLUCKER_ANY_HIT_LAUNCHES == before + 1
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    lists = sparse.window_lists(aabb8, o3, d3u, maxd, sparse.R_BLK)
    plain = sparse.sparse_any_hit_plucker_plain(
        o3, d3u, maxd, intersect.scene_plucker_pack(scene, sparse.PACK_ROWS),
        aabb8, lists, sparse.R_BLK)
    dense = intersect.any_hit_cm(o3, d3u, maxd, scene, mt_impl="plucker")
    torch.cuda.synchronize()
    assert bool(occ.any())
    assert (occ == plain).float().mean().item() >= MIN_AGREE
    assert torch.equal(occ, dense)


@pytest.mark.parametrize("accel,want", [
    ("none", {"dense": 3}), ("sparse", {"sparse": 3, "sparse_any": 3}),
    ("hybrid", {"sparse": 3})])
def test_plucker_render_on_card_matches_cpu(cuda, accel, want):
    if accel == "none":
        scene = arrays.pack_scene(synthetic.cornell_box_scene(16, 16),
                                  pad_to=32, device="cpu")
    else:
        scene = arrays.pack_scene(synthetic.box_field_scene(
            n_boxes=400, width=16, height=16), tri_order="morton",
            device="cpu")
    cfg = RenderConfig(accel=accel, mt_impl="plucker", n_samples=2,
                       n_bounces=3, batch_samples=True)
    read = lambda: {"dense": intersect.PLUCKER_LAUNCHES,
                    "dense_any": intersect.PLUCKER_ANY_HIT_LAUNCHES,
                    "sparse": sparse.PLUCKER_LAUNCHES,
                    "sparse_any": sparse.PLUCKER_ANY_HIT_LAUNCHES,
                    "K1": intersect.LAUNCHES, "K5": sparse.LAUNCHES,
                    "K6": sparse.ANY_HIT_LAUNCHES}
    before = read()
    on_card = render(scene.to(cuda), cfg, seed=5)
    after = read()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == want
    on_cpu = render(scene, cfg, seed=5)
    close = torch.isclose(on_card.cpu(), on_cpu, rtol=RENDER_TOL,
                          atol=RENDER_TOL).all(dim=1)
    assert close.float().mean().item() >= 0.99


def test_mt_impl_on_a_cuda_tensor_never_runs_the_plain_version(cuda,
                                                                monkeypatch):
    scene = _scene("cornell", cuda)
    o3, d3u = _rays(scene)

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")
    monkeypatch.setattr(intersect, "nearest_t_idx_plucker_plain", refuse)
    monkeypatch.setattr(intersect, "nearest_t_idx_plain", refuse)
    intersect.nearest_t_idx_cm(o3, d3u, scene, mt_impl="plucker")
    torch.cuda.synchronize()


# The probes at two sizes (rays, triangles, seed): P1's sign-first sweeps
# (the tensor-core ones on wgmma, tiles built on the card as on the CPU)
# and P2's packed bf16 and 4-ray float32 sweeps against their plain
# versions; bit for bit where the arithmetic is the plain version's.
P1_SIZES = [pytest.param((40000 + 77, 300, 1), id="40077x300"),
            pytest.param((8192, 128, 3), id="8192x128")]
P2_SIZES = [pytest.param((50001, 300, 1), id="50001x300"),
            pytest.param((8192, 128, 3), id="8192x128")]


@pytest.mark.parametrize("size", P1_SIZES)
@pytest.mark.parametrize("variant", ["mt", "plucker_fma", "plucker_tf32",
                                     "plucker_3xtf32"])
def test_mma_probe_kernel_matches_plain(cuda, variant, size):
    from pathtracerpython_tpu_torch.probes import mma_probe

    o3, d3, tripack = mma_probe.make_inputs(*size, cuda)
    packs = mma_probe.make_packs(tripack)
    assert torch.equal(packs.tiles.cpu(),
                       mma_probe.tf32_tiles(packs.pack36.cpu()))
    before = mma_probe.LAUNCHES[variant]
    got = mma_probe.probe(o3, d3, tripack, variant, packs)
    torch.cuda.synchronize()
    assert mma_probe.LAUNCHES[variant] == before + 1
    want = mma_probe.probe_plain(o3, d3, tripack, variant)
    diff = mma_probe.compare(tripack, o3, d3, got, want)
    assert 1.0 - diff["winner_diff_share"] >= MIN_AGREE, diff
    assert diff["max_t_err"] <= 1e-5, diff
    if "tf32" not in variant:   # CUDA-core arithmetic: the plain bits
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    hits = got[1] != mma_probe.IMAX
    assert bool(hits.any())
    assert torch.equal(got[0][~hits], torch.full_like(got[0][~hits],
                                                      mma_probe.BIG))


@pytest.mark.parametrize("size", P2_SIZES)
@pytest.mark.parametrize("variant", ["f32", "bf16"])
def test_bf16_probe_kernel_matches_plain(cuda, variant, size):
    from pathtracerpython_tpu_torch.probes import bf16_probe

    o3, d3, tripack = bf16_probe.make_inputs(*size, cuda)
    before = bf16_probe.LAUNCHES[variant]
    got = bf16_probe.hit_count(o3, d3, tripack, variant)
    torch.cuda.synchronize()
    assert bf16_probe.LAUNCHES[variant] == before + 1
    want = bf16_probe.hit_count_plain(o3, d3, tripack, variant)
    assert got.sum().item() > 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("variant", ["plucker_fma", "plucker_tf32",
                                     "plucker_3xtf32"])
def test_mma_probe_every_pair_inside(cuda, variant):
    """200 copies of one large triangle that every ray's line crosses well
    inside: every pair's sides agree, so the tensor-core sweeps' per-tile
    queue of inside pairs overflows and the lanes compute the rest
    themselves; the winner is the first copy, t the plain version's."""
    from pathtracerpython_tpu_torch.probes import mma_probe

    o3, d3, _ = mma_probe.make_inputs(4096, 1, 5, cuda)
    row = torch.tensor([-1e3, -1e3, 0.0, 3e3, -1e3, 0.0, -1e3, 3e3, 0.0,
                        1.0, 1.0, 0.0], device=cuda)
    tripack = row.repeat(200, 1).contiguous()
    got = mma_probe.probe(o3, d3, tripack, variant)
    want = mma_probe.probe_plain(o3, d3, tripack, variant)
    torch.cuda.synchronize()
    hits = want[1] != mma_probe.IMAX
    assert 0.3 < hits.float().mean().item() < 0.7
    assert torch.equal(got[1], want[1])
    assert bool((want[1][hits] == 0).all())
    assert (got[0] - want[0]).abs().max().item() <= 1e-5


# The box cull of K2, K4 and K3's dense any-hit: the culled kernels give the
# un-culled plain versions' bits on every lane (max abs diff 0), in scene
# order and in morton order.


def _field(order, cuda):
    return arrays.pack_scene(
        synthetic.box_field_scene(n_boxes=300, width=40, height=40),
        device=cuda, **({"tri_order": "morton"} if order == "morton"
                        else {"pad_to": 128}))


@pytest.mark.parametrize("order", ["scene", "morton"])
@pytest.mark.parametrize("form", ["classic", "plucker"])
def test_culled_any_hit_kernel_equals_unculled_plain(cuda, form, order):
    scene = _field(order, cuda)
    o3, d3u, maxd = _shadow_rays(scene)
    tripack = intersect.scene_tripack(scene)
    plucker = form == "plucker"
    pack = intersect.scene_plucker_pack(scene) if plucker else tripack
    pair = intersect.PLUCKER if plucker else intersect.CLASSIC
    launch = (intersect._launch_plucker_any_hit if plucker
              else intersect._launch_any_hit)
    want = intersect.any_hit_plain(o3, d3u, maxd, pack, pair)
    assert torch.equal(intersect.any_hit_cm(o3, d3u, maxd, scene,
                                            mt_impl=form), want)
    cull = intersect.cull_boxes(tripack)
    stats = torch.zeros(3, dtype=torch.int64, device=cuda)
    assert torch.equal(launch(o3, d3u, maxd, pack, cull, stats), want)
    torch.cuda.synchronize()
    counted = intersect.cull_stats(stats, o3.shape[1], pack.shape[0])
    model = []
    intersect.any_hit_plain(o3, d3u, maxd, pack, pair, cull, model)
    # the kernel stops a lane at its first blocking hit, the model counts
    # every pair the cull lets through
    assert 0 < counted["pairs_tested"] <= sum(model)
    assert 0.0 <= counted["tiles_skipped"] < 1.0
    assert 0.5 < counted["groups_skipped"] < 1.0
    occluders = int((tripack[:, 10] > 0.5).sum())
    assert counted["pairs_tested"] < 0.5 * o3.shape[1] * occluders


@pytest.mark.parametrize("order", ["scene", "morton"])
@pytest.mark.parametrize("s_samples", [1, 3, 8])
def test_culled_nee_kernel_equals_unculled_plain(cuda, s_samples, order):
    scene = _field(order, cuda)
    o3, d3u = _rays(scene)
    hit = nearest_hit_cm(o3, d3u, scene)
    normal3 = arrival_side_normal(hit.normal3, d3u).contiguous()
    point3 = hit.point3.contiguous()
    n = point3.shape[1]
    u = torch.from_numpy(np.random.default_rng(s_samples).uniform(
        size=(5 * s_samples, n)).astype(np.float32)).to(cuda)
    tripack, lightpack = intersect.scene_tripack(scene), nee.light_pack(scene)
    pmc, pocc = nee.nee_mean_cos_plain(point3, normal3, u, tripack, lightpack,
                                       s_samples)
    mc, occ = nee.nee_mean_cos_fused(point3, normal3, u, scene, s_samples)
    assert torch.equal(occ, pocc)
    torch.testing.assert_close(mc, pmc, rtol=0, atol=MC_ATOL)
    stats = torch.zeros(3, dtype=torch.int64, device=cuda)
    mc, occ = nee._launch(point3, normal3, u, tripack, lightpack, s_samples,
                          intersect.cull_boxes(tripack), stats)
    assert torch.equal(occ, pocc)
    torch.cuda.synchronize()
    assert 0 < int(stats[2]) < 0.5 * occ.numel() * tripack.shape[0]


# The box cull of K1 and K3's dense nearest: the culled kernels give the
# culled plain model's winners and t on every lane (max abs diff 0), and the
# un-culled plain version's under the bounds above, in scene order and in
# morton order.


@pytest.mark.parametrize("order", ["scene", "morton"])
@pytest.mark.parametrize("form", ["classic", "plucker"])
def test_culled_nearest_kernel_equals_culled_model(cuda, form, order):
    scene = _field(order, cuda)
    o3, d3u = _rays(scene)
    tripack = intersect.scene_tripack(scene)
    plucker = form == "plucker"
    pack = intersect.scene_plucker_pack(scene) if plucker else tripack
    pair = intersect.PLUCKER if plucker else intersect.CLASSIC
    launch = intersect._launch_plucker if plucker else intersect._launch
    cull = intersect.nearest_cull_boxes(tripack)
    model = []
    mt, midx = intersect.nearest_t_idx_plain(o3, d3u, pack, pair, cull, model)
    t, idx = intersect.nearest_t_idx_cm(o3, d3u, scene, mt_impl=form)
    assert torch.equal(idx, midx) and torch.equal(t, mt)
    pt, pidx = intersect.nearest_t_idx_plain(o3, d3u, pack, pair)
    same = idx == pidx
    assert same.float().mean().item() >= MIN_AGREE
    torch.testing.assert_close(t[same], pt[same], rtol=T_RTOL, atol=T_ATOL)
    stats = torch.zeros(3, dtype=torch.int64, device=cuda)
    ct, cidx = launch(o3, d3u, pack, cull, stats)
    assert torch.equal(cidx, midx) and torch.equal(ct, mt)
    torch.cuda.synchronize()
    counted = intersect.cull_stats(stats, o3.shape[1], pack.shape[0])
    assert counted["pairs_tested"] == model[0]
    every = o3.shape[1] * int((tripack[:, 9] > 0.5).sum())
    assert 0 < counted["pairs_tested"] < 0.05 * every
    assert 0.0 <= counted["tiles_skipped"] < 1.0
    assert 0.5 < counted["groups_skipped"] < 1.0


@pytest.mark.parametrize("entry", ["ptt_nearest_t_idx",
                                   "ptt_plucker_nearest_t_idx"])
def test_nearest_entry_refuses_null_boxes(cuda, entry):
    """cudaErrorInvalidValue (1) for a pack of rows without its boxes; the
    wrapper would raise on it."""
    scene = _scene("cornell", cuda)
    o3, d3u = _rays(scene)
    pack = (intersect.scene_plucker_pack(scene) if "plucker" in entry
            else intersect.scene_tripack(scene))
    cull = intersect.nearest_cull_boxes(intersect.scene_tripack(scene))
    n = o3.shape[1]
    t = torch.empty(n, device=cuda)
    idx = torch.empty(n, dtype=torch.int32, device=cuda)
    fn = build.function(entry, intersect._ARGTYPES)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for tile, group in ((None, cull.group.data_ptr()),
                        (cull.tile.data_ptr(), None)):
        assert fn(o3.data_ptr(), d3u.data_ptr(), n, pack.data_ptr(),
                  pack.shape[0], tile, group, t.data_ptr(), idx.data_ptr(),
                  None, cuda.index or 0, stream) == 1
    none = torch.empty((0, 8), device=cuda)   # no allocation: a null pointer
    assert none.data_ptr() == 0
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        intersect._launch_nearest(o3, d3u, pack, entry,
                                  intersect.CullBoxes(none, cull.group))


# The split walk of K5 (both forms) and K8 (csrc/cluster.cuh): each block's
# list in units of WALK_SEGMENT slots on many CTAs, each lane's best merged
# by a 64-bit atomicMin. The kernels give the serial plain walk's winners
# and t on every lane whatever order their units ran in, and the visits of
# their counting instances lie in the band of ``walk_visit_band``.


def _walk(scene, which, form, o3, d3u):
    """(pack, aabb8, lists, r_blk, launch, pair) of K5 in blocks of
    ``which`` ("512", "1024") in ``form``, or of K8 ("walker")."""
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    if which == "walker":
        return (tripack, aabb8, walker.nearest_lists(aabb8, o3, d3u),
                walker.R_BLK, walker._launch_nearest, intersect.CLASSIC)
    r_blk = int(which)
    nrb = -(-o3.shape[1] // r_blk)
    lists = sparse.block_lists(aabb8, o3, d3u, torch.full(
        (nrb,), intersect.BIG, device=o3.device), r_blk)
    if form == "plucker":
        return (intersect.scene_plucker_pack(scene, sparse.PACK_ROWS), aabb8,
                lists, r_blk, sparse._launch_plucker, intersect.PLUCKER)
    return tripack, aabb8, lists, r_blk, sparse._launch, intersect.CLASSIC


WALKS = [("512", "classic"), ("1024", "classic"), ("512", "plucker"),
         ("1024", "plucker"), ("walker", "classic")]


@pytest.mark.parametrize("which,form", WALKS)
def test_split_walk_kernel_equals_serial_plain_walk(cuda, which, form):
    scene = _scene("large", cuda)    # 188 clusters
    o3, d3u = _rays(scene)
    pack, aabb8, lists, r_blk, launch, pair = _walk(scene, which, form, o3,
                                                    d3u)
    assert int(lists.ncand.max()) > 4 * sparse.WALK_SEGMENT
    visits = []
    pt, pidx = sparse.sparse_nearest_plain(o3, d3u, pack, aabb8, lists,
                                           r_blk, visits, pair)
    stats = torch.zeros(3, dtype=torch.int64, device=cuda)
    ct, cidx = launch(o3, d3u, pack, aabb8, lists, r_blk, stats)
    t, idx = launch(o3, d3u, pack, aabb8, lists, r_blk)
    torch.cuda.synchronize()
    assert (idx >= 0).any() and (idx < 0).any()
    for got_t, got_idx in ((t, idx), (ct, cidx)):
        assert torch.equal(got_idx, pidx) and torch.equal(got_t, pt)
    counted = sparse.walk_stats(stats)
    assert counted["units_launched"] == sparse.walk_units(lists, r_blk)
    assert 0 <= counted["units_stopped_at_once"] < counted["units_launched"]
    floor, ceiling = sparse.walk_visit_band(
        o3, d3u, pack, aabb8, lists, r_blk, t, idx, sparse.WALK_SEGMENT, pair)
    assert floor <= counted["visits"] <= ceiling
    assert floor <= int(sum(int(v) for v in visits)) <= ceiling


@pytest.mark.parametrize("which,form", WALKS)
def test_split_walk_kernel_with_one_segment_per_list(cuda, which, form):
    """Lists within one segment (the Cornell stand-in has 4 clusters): one
    unit a block slice, the serial walk visit for visit."""
    scene = _scene("cornell", cuda)
    o3, d3u = _rays(scene)
    pack, aabb8, lists, r_blk, launch, pair = _walk(scene, which, form, o3,
                                                    d3u)
    assert int(lists.ncand.max()) <= sparse.WALK_SEGMENT
    visits = []
    pt, pidx = sparse.sparse_nearest_plain(o3, d3u, pack, aabb8, lists,
                                           r_blk, visits, pair)
    stats = torch.zeros(3, dtype=torch.int64, device=cuda)
    t, idx = launch(o3, d3u, pack, aabb8, lists, r_blk, stats)
    torch.cuda.synchronize()
    assert torch.equal(idx, pidx) and torch.equal(t, pt)
    counted = sparse.walk_stats(stats)
    assert counted["units_launched"] == sparse.walk_units(lists, r_blk)
    assert counted["visits"] == int(sum(int(v) for v in visits))


@pytest.mark.parametrize("entry", ["ptt_sparse_nearest",
                                   "ptt_plucker_sparse_nearest",
                                   "ptt_walker_nearest"])
def test_split_walk_entry_refuses_null_scratch(cuda, entry):
    """cudaErrorInvalidValue (1) without the scratch words."""
    scene = _scene("large", cuda)
    o3, d3u = _rays(scene)
    which = "walker" if "walker" in entry else "1024"
    form = "plucker" if "plucker" in entry else "classic"
    pack, aabb8, lists, r_blk, _, _ = _walk(scene, which, form, o3, d3u)
    n = o3.shape[1]
    t = torch.empty(n, device=cuda)
    idx = torch.empty(n, dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    if which == "walker":
        fn = build.function(entry, walker._NEAREST_ARGTYPES)
        err = fn(o3.data_ptr(), d3u.data_ptr(), n, pack.data_ptr(),
                 aabb8.data_ptr(), lists.ids.data_ptr(), lists.keys.data_ptr(),
                 lists.ncand.data_ptr(), lists.ids.shape[1], r_blk, None,
                 t.data_ptr(), idx.data_ptr(), None, cuda.index or 0, stream)
    else:
        fn = build.function(entry, sparse._ARGTYPES)
        err = fn(o3.data_ptr(), d3u.data_ptr(), n, pack.data_ptr(),
                 aabb8.data_ptr(), aabb8.shape[0], lists.ids.data_ptr(),
                 lists.keys.data_ptr(), lists.ncand.data_ptr(), r_blk, None,
                 t.data_ptr(), idx.data_ptr(), None, cuda.index or 0, stream)
    assert err == 1


# The split any-hit walk of K6 (both forms) and K9 (csrc/any_hit_walk.cuh):
# each block's list in units of ANY_HIT_SEGMENT slots on many CTAs, merged per
# lane by its occlusion mark, each visited cluster culled by span, mid and
# group boxes. The kernels give their culled plain model's bits on every
# lane whatever order their units ran in, and the counts of their counting
# instances lie in the band of ``any_hit_visit_band``.


def _any_hit(scene, which, form, o3, d3u, maxd):
    """(pack, aabb8, lists, r_blk, launch, pair) of K6 in ``form`` ("sparse")
    or of K9 ("walker")."""
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    if which == "walker":
        return (tripack, aabb8, walker.walker_lists(aabb8, o3, d3u, maxd),
                walker.R_BLK, walker._launch, intersect.CLASSIC)
    lists = sparse.window_lists(aabb8, o3, d3u, maxd, sparse.R_BLK)
    if form == "plucker":
        return (intersect.scene_plucker_pack(scene, sparse.PACK_ROWS), aabb8,
                lists, sparse.R_BLK, sparse._launch_plucker_any_hit,
                intersect.PLUCKER)
    return (tripack, aabb8, lists, sparse.R_BLK, sparse._launch_any_hit,
            intersect.CLASSIC)


ANY_HITS = [("sparse", "classic"), ("sparse", "plucker"),
            ("walker", "classic")]


@pytest.mark.parametrize("which,form", ANY_HITS)
@pytest.mark.parametrize("scene_name", ["large", "cornell"])
def test_split_any_hit_kernel_equals_culled_model(cuda, scene_name, which,
                                                  form):
    """On the 2000-box field (lists of many segments) and the Cornell
    stand-in (lists of one): bits equal to the culled model's and to the
    un-culled serial walk's on every lane, the counting instance's too, its
    units those the lists give, and its counts inside their band."""
    scene = _scene(scene_name, cuda)
    o3, d3u, maxd = _shadow_rays(scene)
    pack, aabb8, lists, r_blk, launch, pair = _any_hit(scene, which, form,
                                                       o3, d3u, maxd)
    cull = sparse.scene_cluster_cull_boxes(scene)
    counts = {}
    model = sparse.any_hit_walk(o3, d3u, maxd, pack, aabb8, lists, r_blk,
                                pair=pair, cull=cull, counts=counts)[0]
    serial = sparse.any_hit_walk(o3, d3u, maxd, pack, aabb8, lists, r_blk,
                                 pair=pair)[0]
    stats = torch.zeros(len(sparse.ANY_HIT_COUNTS), dtype=torch.int64,
                        device=cuda)
    counted = launch(o3, d3u, maxd, pack, aabb8, lists, r_blk, cull, stats)
    occ = launch(o3, d3u, maxd, pack, aabb8, lists, r_blk, cull)
    torch.cuda.synchronize()
    assert bool(occ.any()) and not bool(occ.all())
    for got in (occ, counted, serial):
        assert torch.equal(got, model)
    got = sparse.any_hit_stats(stats)
    assert got["units_launched"] == sparse.walk_units(
        lists, r_blk, sparse.ANY_HIT_SEGMENT)
    assert 0 <= got["units_stopped_at_once"] < got["units_launched"]
    band = sparse.any_hit_visit_band(o3, d3u, maxd, pack, aabb8, lists,
                                     r_blk, model, sparse.ANY_HIT_SEGMENT,
                                     pair, cull)
    for key, (floor, ceiling) in band.items():
        assert floor <= got[key] <= ceiling, (key, got[key], floor, ceiling)
        assert floor <= counts[key] <= ceiling, key
    assert got["pairs_tested"] <= sparse.C_TRI * got["visits"]
    if int(lists.ncand.max()) <= sparse.ANY_HIT_SEGMENT:
        # one unit a block slice: the serial walk, count for count
        assert {k: got[k] for k in counts} == counts


@pytest.mark.parametrize("which,form", ANY_HITS)
def test_split_any_hit_entry_refuses_null_boxes(cuda, which, form):
    """cudaErrorInvalidValue (1) without the cluster boxes."""
    scene = _scene("large", cuda)
    o3, d3u, maxd = _shadow_rays(scene)
    pack, aabb8, lists, r_blk, _, _ = _any_hit(scene, which, form, o3, d3u,
                                               maxd)
    entry = {"walker": "ptt_walker_any_hit", "classic": "ptt_sparse_any_hit",
             "plucker": "ptt_plucker_sparse_any_hit"}[
                 "walker" if which == "walker" else form]
    fn = build.function(entry, sparse._ANY_HIT_ARGTYPES)
    n = o3.shape[1]
    occ = torch.zeros(n, dtype=torch.bool, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert fn(o3.data_ptr(), d3u.data_ptr(), maxd.data_ptr(), n,
              pack.data_ptr(), aabb8.data_ptr(), None, lists.ids.data_ptr(),
              lists.keys.data_ptr(), lists.ncand.data_ptr(),
              lists.ids.shape[1], r_blk, occ.data_ptr(), None,
              cuda.index or 0, stream) == 1


# Gradients on the card against the plain versions on the CPU: the same
# params, target and key; the card's rsqrt, sin and cos and the order of
# its float sums (the backwards' scatters) round differently, so each
# field's gradient may differ in the last bits. Relative L2 per field.
GRAD_RTOL = 1e-4
GRAD_CASES = {
    "fused": ("cornell", dict(n_light_samples=3)),
    "unfused9": ("cornell", dict(n_light_samples=9)),
    "plucker": ("cornell", dict(n_light_samples=3, mt_impl="plucker")),
    "sparse": ("field", dict(accel="sparse")),
    "walker": ("field", dict(accel="walker")),
    "hybrid": ("field", dict(accel="hybrid")),
}


def _camera_grads(scene, cfg, params, target):
    from pathtracerpython_tpu_torch.diff import (
        camera_pixel_loss,
        make_render_fn,
    )

    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    pids = torch.arange(target.shape[0], device=scene.device)
    loss = camera_pixel_loss(leaves, scene, target, make_render_fn(cfg),
                             pids, (0, 4))
    loss.backward()
    return loss.item(), {k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_grads_on_card_match_cpu(cuda, case):
    which, kw = GRAD_CASES[case]
    desc = (synthetic.cornell_box_scene(32, 32) if which == "cornell" else
            synthetic.box_field_scene(n_boxes=400, width=32, height=32))
    scene = arrays.pack_scene(desc, pad_to=32, device="cpu",
                              tri_order=None if which == "cornell"
                              else "morton")
    cfg = RenderConfig(n_samples=2, n_bounces=2, **kw)
    with torch.no_grad():
        target = 0.5 * render(scene, cfg, seed=1)
    params = {f: getattr(scene, f) for f in (
        "mat_rgb", "light_color", "ambient", "tri_v0", "light_v0", "eye",
        "ortho")}
    params["eye"] = scene.eye + torch.tensor([0.03, -0.02, 0.05])
    k1 = intersect.LAUNCHES
    loss_c, got = _camera_grads(scene.to(cuda),
                                cfg, {k: v.to(cuda) for k, v in
                                      params.items()}, target.to(cuda))
    loss_h, want = _camera_grads(scene, cfg, params, target)
    assert case not in ("fused", "unfused9") or intersect.LAUNCHES > k1
    assert abs(loss_c - loss_h) <= 1e-5 * abs(loss_h)
    for k, w in want.items():
        g = got[k].cpu()
        assert torch.isfinite(g).all(), k
        assert (g - w).norm() <= GRAD_RTOL * w.norm() + 1e-12, (
            k, ((g - w).norm() / w.norm()).item())


def test_functions_leave_the_forward_alone(cuda):
    """K1 under NearestTIdx and K2 under NeeMeanCos: the no-grad calls'
    bits, one launch each."""
    import dataclasses as dc

    scene = _scene("boxfield300", cuda)
    o3, d3u = _rays(scene)
    t0, i0 = intersect.nearest_t_idx_cm(o3, d3u, scene)
    grad_scene = dc.replace(scene, **{
        f: getattr(scene, f).clone().requires_grad_(True)
        for f in ("tri_v0", "light_v0")})
    k1 = intersect.LAUNCHES
    t1, i1 = intersect.nearest_t_idx_cm(o3.clone().requires_grad_(True),
                                        d3u, grad_scene)
    assert intersect.LAUNCHES == k1 + 1 and t1.requires_grad
    assert torch.equal(t1.detach(), t0) and torch.equal(i1, i0)
    point3 = (o3 + d3u * t0[None]).contiguous()
    normal3 = torch.zeros_like(point3)
    normal3[1] = 1.0
    u = torch.rand((15, point3.shape[1]), device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(0))
    mc0, occ0 = nee.nee_mean_cos_fused(point3, normal3, u, scene, 3)
    k2 = nee.LAUNCHES
    mc1, occ1 = nee.nee_mean_cos_fused(point3.requires_grad_(True), normal3,
                                       u, grad_scene, 3)
    assert nee.LAUNCHES == k2 + 1 and mc1.requires_grad
    assert torch.equal(mc1.detach(), mc0) and torch.equal(occ1, occ0)
    mc1.sum().backward()
    assert torch.isfinite(grad_scene.light_v0.grad).all()
    assert nee.LAUNCHES == k2 + 1  # the backward launches no kernel


@pytest.mark.parametrize("accel", ["sparse", "hybrid", "walker"])
def test_hierarchy_sweep_grads_on_card_equal_dense(cuda, accel):
    """The summed hit distance's gradients through K5 (both block sizes)
    and K8 against K1's on the card: the same winners and the same
    backward, so they differ at most by the order of the scatter's float
    sums."""
    import dataclasses as dc

    scene = _scene("large", cuda)
    o3, d3u = _rays(scene)
    sweeps = {
        "none": intersect.nearest_t_idx_cm,
        "sparse": sparse.sparse_nearest_t_idx_cm,
        "hybrid": lambda o, d, sc: sparse.sparse_nearest_t_idx_cm(
            o, d, sc, r_blk=sparse.R_BLK_HYBRID_NEAREST),
        "walker": walker.walker_nearest_t_idx_cm,
    }
    grads = {}
    for name in ("none", accel):
        v0 = scene.tri_v0.clone().requires_grad_(True)
        o = o3.clone().requires_grad_(True)
        t, idx = sweeps[name](o, d3u, dc.replace(scene, tri_v0=v0))
        t.sum().backward()
        grads[name] = (idx, v0.grad, o.grad)
    assert torch.equal(grads["none"][0], grads[accel][0])
    for want, got in zip(grads["none"][1:], grads[accel][1:]):
        assert want.abs().sum() > 0
        assert (got - want).norm() <= 1e-6 * want.norm()


# The soft estimator (diff/boundary.py) on the card: plain PyTorch, no
# kernel, held against the same estimator on the CPU; and remat_bounces,
# whose recompute launches K1 and K2 again.
SOFT_BETA = 0.05
SOFT_SCENES = {"occluder": (lambda: synthetic.occluder_scene(32, 32), 1),
               "cornell": (lambda: synthetic.cornell_box_scene(32, 32), 5)}


def _kernel_launches():
    return (intersect.LAUNCHES + intersect.ANY_HIT_LAUNCHES + nee.LAUNCHES
            + sparse.LAUNCHES + sparse.ANY_HIT_LAUNCHES
            + sparse.ANY_HIT_IDX_LAUNCHES + walker.LAUNCHES
            + walker.NEAREST_LAUNCHES)


def _translation_grad(scene, cfg, obj, target):
    from pathtracerpython_tpu_torch.diff.transforms import translate_object

    p = torch.tensor([0.05, -0.03], device=scene.device, requires_grad=True)
    moved = translate_object(scene, obj, torch.stack(
        [p[0], torch.zeros((), device=scene.device), p[1]]))
    w, h = scene.meta.width, scene.meta.height
    o, d = make_primary_rays(scene.eye, scene.ortho, w, h)
    from pathtracerpython_tpu_torch.render.integrator import render_rays

    rad = render_rays(o, d, torch.arange(w * h, device=scene.device), moved,
                      cfg, (0, 3))
    (0.5 * ((rad - target) ** 2).mean()).backward()
    return p.grad.cpu()


@pytest.mark.parametrize("which", sorted(SOFT_SCENES))
def test_soft_render_and_grads_on_card_match_cpu(cuda, which):
    make, obj = SOFT_SCENES[which]
    scene = arrays.pack_scene(make(), device="cpu")
    cfg = RenderConfig(n_samples=1, n_bounces=2, n_light_samples=2,
                       soft_vis_beta=SOFT_BETA)
    before = _kernel_launches()
    got = render(scene.to(cuda), cfg, seed=3)
    assert _kernel_launches() == before  # no kernel on the soft path
    want = render(scene, cfg, seed=3)
    close = torch.isclose(got.cpu(), want, rtol=RENDER_TOL,
                          atol=RENDER_TOL).all(dim=1)
    assert close.float().mean() >= 0.99
    target = 0.5 * want
    g = _translation_grad(scene.to(cuda), cfg, obj, target.to(cuda))
    w = _translation_grad(scene, cfg, obj, target)
    assert w.norm() > 0 and (g - w).norm() <= GRAD_RTOL * w.norm(), (g, w)


def test_soft_cluster_records_on_card_equal_dense(cuda):
    """The 600-box field's camera rays at 64x64: the cluster sweep's
    records are the dense sweep's on every lane."""
    from pathtracerpython_tpu_torch.diff import boundary

    scene = arrays.pack_scene(synthetic.box_field_scene(
        n_boxes=600, width=64, height=64), tri_order="morton", device=cuda)
    o, d = make_primary_rays(scene.eye, scene.ortho, 64, 64)
    before = boundary.FALLBACKS
    sparse_rec = boundary.soft_hits_sweep_sparse(o, d, scene, 0.03)
    assert boundary.FALLBACKS == before
    dense_rec = boundary.soft_hits_sweep_dense(o, d, scene, 0.03)
    for a, b in zip(sparse_rec, dense_rec):
        assert torch.equal(a, b)


def test_remat_doubles_launches_on_card(cuda):
    """A training step of the Cornell stand-in (32x32, 1 spp, 2 bounces):
    K1 and K2 launch once per bounce, twice under remat_bounces; the
    gradients agree but for the order of the scatters' float sums."""
    from pathtracerpython_tpu_torch.diff import (
        camera_pixel_loss,
        make_render_fn,
    )

    scene = arrays.pack_scene(synthetic.cornell_box_scene(32, 32),
                              pad_to=32, device=cuda)
    cfg = RenderConfig(n_samples=1, n_bounces=2)
    with torch.no_grad():
        target = 0.5 * render(scene, cfg, seed=1)
    pids = torch.arange(target.shape[0], device=cuda)
    out = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat_bounces=remat)
        leaves = {f: getattr(scene, f).clone().requires_grad_(True)
                  for f in ("tri_v0", "light_v0", "mat_rgb")}
        k1, k2 = intersect.LAUNCHES, nee.LAUNCHES
        camera_pixel_loss(leaves, scene, target, make_render_fn(c), pids,
                          (0, 4)).backward()
        torch.cuda.synchronize()
        out[remat] = (intersect.LAUNCHES - k1, nee.LAUNCHES - k2,
                      {k: v.grad for k, v in leaves.items()})
    assert out[False][:2] == (2, 2) and out[True][:2] == (4, 4)
    for k, w in out[False][2].items():
        assert (out[True][2][k] - w).norm() <= 1e-6 * w.norm(), k


def test_ring_of_one_shard_on_card_is_k1(cuda):
    """The geometry ring's fast sweep on the card (a mesh of one rank: one
    step, no rotation) launches K1 and K4 once with the home shard's own
    box tables, and gives the dense sweeps' records."""
    from pathtracerpython_tpu_torch.ops.geometry import any_hit_within_cm
    from pathtracerpython_tpu_torch.parallel import make_mesh
    from pathtracerpython_tpu_torch.parallel.mesh import active

    scene = _scene("boxfield300", cuda)
    o, d = make_primary_rays(scene.eye, scene.ortho, scene.meta.width,
                             scene.meta.height)
    o3, d3 = o.T.contiguous(), d.T.contiguous()
    maxd = torch.full((o3.shape[1],), 5.0, device=cuda)
    with torch.no_grad():
        want = nearest_hit_cm(o3, d3, scene, accel="none")
        want_occ = any_hit_within_cm(o3, normalize3(d3), maxd, scene)
        intersect.LAUNCHES = intersect.ANY_HIT_LAUNCHES = 0
        with active(make_mesh(device=cuda)):
            got = nearest_hit_cm(o3, d3, scene, geom_axis="geom")
            occ = any_hit_within_cm(o3, normalize3(d3), maxd, scene,
                                    geom_axis="geom")
    assert intersect.LAUNCHES == 1 and intersect.ANY_HIT_LAUNCHES == 1
    assert torch.equal(got.hit, want.hit) and torch.equal(occ, want_occ)
    assert torch.equal(got.tri_idx, want.tri_idx)
    assert torch.equal(got.t, want.t)


def test_dryrun_multichip_two_ranks_share_the_card(cuda):
    """Two ranks on the one card talk through gloo with host staging; the
    dry run's shapes pass there (the pipeline bit-equal to one rank)."""
    from pathtracerpython_tpu_torch.entry import dryrun_multichip

    lines = []
    dryrun_multichip(2, log=lines.append)
    text = "\n".join(lines)
    assert "through host buffers" in text and "on cuda:0" in text
    assert "pp-pipeline render bit-matches single" in text


def _parked_rays(scene, cuda):
    """``_rays`` with the lanes 400-699 parked, as the integrator parks
    dead lanes."""
    from pathtracerpython_tpu_torch.ops.sort import PARK_DIR, PARK_ORIGIN

    o3, d3u = _rays(scene)
    o3[:, 400:700] = torch.tensor(PARK_ORIGIN, device=cuda)[:, None]
    d3u[:, 400:700] = torch.tensor(PARK_DIR, device=cuda)[:, None]
    return o3, d3u


@pytest.mark.parametrize("which", ["nearest", "any-hit"])
@pytest.mark.parametrize("r_blk", [512, 1024])
def test_two_pass_select_kernel_equals_plain(cuda, which, r_blk,
                                             monkeypatch):
    """csrc/two_pass.cu's flags and bound against its plain twin
    ``two_pass_flags_plain``, bit for bit, on pass 1 of K5 (its merged
    words) or K6, parked lanes included, at both LANE_M."""
    scene = _scene("boxfield2000", cuda)
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    if which == "nearest":
        o3, d3u = _parked_rays(scene, cuda)
        nrb = -(-o3.shape[1] // r_blk)
        lists = sparse.block_lists(aabb8, o3, d3u, torch.full(
            (nrb,), intersect.BIG, device=cuda), r_blk)
    else:
        o3, d3u, maxd = _shadow_rays(scene)
        r_blk = sparse.R_BLK
        lists = sparse.window_lists(aabb8, o3, d3u, maxd, r_blk)
    for lane_m in (0, sparse.LANE_M):
        monkeypatch.setattr(sparse, "LANE_M", lane_m)
        head, drops = sparse.truncate_lists(lists, sparse.PASS1_K)
        before = sparse.SELECT_LAUNCHES
        if which == "nearest":
            words = sparse.walk_words(o3.shape[1], cuda)
            t1, i1 = sparse._launch(o3, d3u, tripack, aabb8, head, r_blk,
                                    words=words)
            flags, ne = sparse.nearest_select(o3, d3u, aabb8, drops, r_blk,
                                              t1, i1, words, want_ne=True)
            want = sparse.two_pass_flags_plain(
                o3, d3u, aabb8, drops, r_blk,
                torch.where(i1 >= 0, t1, intersect.BIG))
        else:
            cull = sparse.scene_cluster_cull_boxes(scene)
            occ1 = sparse._launch_any_hit(o3, d3u, maxd, tripack, aabb8,
                                          head, r_blk, cull)
            flags, ne = sparse.any_hit_select(o3, d3u, maxd, occ1, aabb8,
                                              drops, r_blk, want_ne=True)
            want = sparse.two_pass_flags_plain(
                o3, d3u, aabb8, drops, r_blk, maxd,
                sparse.any_hit_open(occ1, maxd))
        assert sparse.SELECT_LAUNCHES == before + 1
        assert torch.equal(flags, want[0]) and torch.equal(ne, want[1])
        assert flags.any() and not flags.all()


@pytest.mark.parametrize("form", ["classic", "plucker"])
@pytest.mark.parametrize("r_blk", [512, 1024])
def test_two_pass_nearest_on_card_equals_one_pass(cuda, r_blk, form):
    """K5 (or K3's sparse nearest) in two passes, pass 2 compacted or the
    whole wavefront again, gives the one-pass winners and t bit for bit."""
    scene = _scene("boxfield2000", cuda)
    o3, d3u = _parked_rays(scene, cuda)
    want = sparse.sparse_nearest_t_idx_cm(o3, d3u, scene, r_blk=r_blk,
                                          mt_impl=form, two_pass=0)
    for k, m_div in ((4, 1), (4, 10**6), (1, 2), (2, sparse.M_DIV)):
        before = sparse.SELECT_LAUNCHES
        got = sparse.sparse_nearest_t_idx_cm(o3, d3u, scene, r_blk=r_blk,
                                             mt_impl=form, two_pass=k,
                                             m_div=m_div)
        assert sparse.SELECT_LAUNCHES == before + 1
        assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


@pytest.mark.parametrize("form", ["classic", "plucker"])
def test_two_pass_any_hit_on_card_equals_one_pass(cuda, form):
    scene = _scene("boxfield2000", cuda)
    o3, d3u, maxd = _shadow_rays(scene)
    want = sparse.sparse_any_hit_cm(o3, d3u, maxd, scene, mt_impl=form,
                                    two_pass=0)
    for k, m_div in ((4, 1), (4, 10**6), (1, 2), (2, sparse.M_DIV)):
        got = sparse.sparse_any_hit_cm(o3, d3u, maxd, scene, mt_impl=form,
                                       two_pass=k, m_div=m_div)
        assert torch.equal(got, want)



def _select_case(which, r_blk, cuda, lane_m, monkeypatch):
    """The 2000-box field's pass 1 of ``which`` in blocks of ``r_blk`` at
    LANE_M ``lane_m``: (rays (o3, d3u, maxd or None), the full lists, the
    scene's box, ``select(m, **kw)``: the kernel's entry on it, ``plain(m)``:
    (its plain Selection, the plain flags, the plain bound or None))."""
    scene = _scene("boxfield2000", cuda)
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    box = sparse.scene_cluster_box(scene)
    monkeypatch.setattr(sparse, "LANE_M", lane_m)
    if which == "nearest":
        o3, d3u = _parked_rays(scene, cuda)
        maxd = None
        nrb = -(-o3.shape[1] // r_blk)
        lists = sparse.block_lists(aabb8, o3, d3u, torch.full(
            (nrb,), intersect.BIG, device=cuda), r_blk)
        head, drops = sparse.truncate_lists(lists, sparse.PASS1_K)
        words = sparse.walk_words(o3.shape[1], cuda)
        t1, i1 = sparse._launch(o3, d3u, tripack, aabb8, head, r_blk,
                                words=words)
        select = lambda m, **kw: sparse.nearest_select_compact(
            o3, d3u, aabb8, box, drops, r_blk, t1, i1, words, m,
            lists.ncand, **kw)
        flags_of = lambda: sparse.two_pass_flags_plain(
            o3, d3u, aabb8, drops, r_blk,
            torch.where(i1 >= 0, t1, intersect.BIG), box=box)
    else:
        o3, d3u, maxd = _shadow_rays(scene)
        lists = sparse.window_lists(aabb8, o3, d3u, maxd, r_blk)
        head, drops = sparse.truncate_lists(lists, sparse.PASS1_K)
        occ1 = sparse._launch_any_hit(o3, d3u, maxd, tripack, aabb8, head,
                                      r_blk,
                                      sparse.scene_cluster_cull_boxes(scene))
        if which == "any-hit":
            select = lambda m, **kw: sparse.any_hit_select_compact(
                o3, d3u, maxd, occ1, aabb8, box, drops, r_blk, m,
                lists.ncand, **kw)
            flags_of = lambda: sparse.two_pass_flags_plain(
                o3, d3u, aabb8, drops, r_blk, maxd,
                sparse.any_hit_open(occ1, maxd), box=box)
        else:   # the compact entry on the open lanes, as the cache's
            unfinished = sparse.any_hit_open(occ1, maxd)
            select = lambda m, **kw: sparse.select_compact(
                unfinished, m, o3, d3u, maxd, lists.ncand)
            flags_of = lambda: (unfinished, None)

    def plain(m):
        flags, ne = flags_of()
        return (sparse.select_compact_plain(flags, m, o3, d3u, maxd,
                                            lists.ncand), flags, ne)

    return (o3, d3u, maxd), lists, select, plain


@pytest.mark.parametrize("which", ["nearest", "any-hit", "compact"])
@pytest.mark.parametrize("r_blk", [512, 1024])
def test_select_compact_kernel_equals_plain(cuda, which, r_blk,
                                            monkeypatch):
    """csrc/two_pass.cu's three entries against their plain twins
    (``two_pass_flags_plain``, ``select_compact_plain``) bit for bit: the
    slots, the count, ``taken``, pass 2's rays (and windows), the
    fallback's counts, the flags and the bound; on pass 1 of K5 or K6,
    parked lanes included, at LANE_M 0 and 8, both branches forced (one
    slot: the fallback; N slots: compacted). One launch a call."""
    for lane_m in (0, sparse.LANE_M):
        rays, lists, select, plain = _select_case(which, r_blk, cuda,
                                                  lane_m, monkeypatch)
        n = rays[0].shape[1]
        for m in (1, n):
            before = sparse.SELECT_LAUNCHES
            got = select(m) if which == "compact" else select(
                m, want_flags=True, want_ne=True)
            assert sparse.SELECT_LAUNCHES == before + 1
            want, flags, ne = plain(m)
            torch.cuda.synchronize()
            cnt = int(want.count[0])
            assert 0 < cnt < n
            assert bool(got.taken[0]) == (m == 1) == bool(want.taken[0])
            for g, w in zip((got.sel, got.count, got.taken, *got.rays,
                             got.ncand_fb),
                            (want.sel, want.count, want.taken, *want.rays,
                             want.ncand_fb)):
                assert g.dtype == w.dtype and torch.equal(g, w)
            if which != "compact":
                assert torch.equal(got.flags, flags)
                assert torch.equal(got.ne, ne)


@pytest.mark.parametrize("which", ["nearest", "any-hit", "compact"])
def test_select_compact_bit_equal_across_launches_and_streams(
        cuda, which, monkeypatch):
    """Three launches on the current stream and one on a second stream give
    the same slots, count and rays: the positions are prefix sums in lane
    order, whatever order the CTAs run in."""
    rays, _, select, _ = _select_case(which, sparse.R_BLK, cuda,
                                      sparse.LANE_M, monkeypatch)
    m = sparse.pass2_size(rays[0].shape[1], sparse.R_BLK, 1)
    runs = [select(m) for _ in range(3)]
    side = torch.cuda.Stream(device=cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        runs.append(select(m))
    torch.cuda.current_stream(cuda).wait_stream(side)
    torch.cuda.synchronize()
    assert not bool(runs[0].taken[0])
    for r in runs[1:]:
        for g, w in zip((r.sel, r.count, *r.rays), (runs[0].sel,
                                                    runs[0].count,
                                                    *runs[0].rays)):
            assert torch.equal(g, w)


@pytest.mark.parametrize("form", ["classic", "plucker"])
def test_two_pass_wrappers_read_nothing_back(cuda, form):
    """The two-pass sweeps, in both branches, run clean under the sync
    debug mode "error" (no host read, so no stream sync) and give the
    one-pass results bit for bit."""
    scene = _scene("boxfield2000", cuda)
    o3, d3u = _parked_rays(scene, cuda)
    so, sd, maxd = _shadow_rays(scene)
    calls = {
        "nearest": lambda k, m_div: sparse.sparse_nearest_t_idx_cm(
            o3, d3u, scene, mt_impl=form, two_pass=k, m_div=m_div),
        "any-hit": lambda k, m_div: (sparse.sparse_any_hit_cm(
            so, sd, maxd, scene, mt_impl=form, two_pass=k, m_div=m_div),)}
    for name, call in calls.items():
        want = call(0, sparse.M_DIV)
        call(4, 1)    # builds and loads; the scene's box cached
        torch.cuda.synchronize()
        got = {}
        torch.cuda.set_sync_debug_mode("error")
        try:
            for m_div in (1, 10**6):
                got[m_div] = call(4, m_div)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        for m_div, out in got.items():
            assert all(torch.equal(g, w) for g, w in zip(out, want)), (
                name, m_div)

# the table gradients' sum (ops/gather.py:scatter_rows, csrc/scatter_rows.cu):
# (lanes, columns, rows, how the lanes pick their rows) of the bench step's
# three calls (mat_rgb and the light table on the tiny path, the tripack on
# the narrow one), the 100k field's tri_v0 backward (the wide path, sorted),
# each path's edges (``gather.plan``: tiny up to 32 table entries, narrow
# up to 1024) and the other edges
SCATTER_SHAPES = {
    "mat_rgb": (2**20, 3, 8, "skewed"),
    "tripack": (2**20, 9, 64, "skewed"),
    "light_table": (3 * 2**20, 9, 2, "skewed"),
    "rows_100096": (2**18, 9, 100096, "skewed"),
    "one_row": (4097, 3, 1, "skewed"),
    "ragged_1007": (1007, 9, 64, "skewed"),
    "no_lanes": (0, 9, 5, "skewed"),
    "tiny_edge_27": (2**20, 9, 3, "skewed"),
    "narrow_past_tiny_36": (2**20, 9, 4, "skewed"),
    "narrow_edge_1017": (2**20, 9, 113, "skewed"),
    "wide_past_narrow_1026": (2**20, 9, 114, "skewed"),
    "one_column": (2**18, 1, 20, "skewed"),
    "tiny_widest_32": (2**18, 32, 1, "skewed"),
    "narrow_33_columns": (2**18, 33, 2, "skewed"),
    "wide_33_columns": (2**18, 33, 40, "skewed"),
    "narrow_every_lane_one_row": (2**20, 9, 64, "one"),
    "wide_every_lane_one_row": (2**18, 9, 100096, "one"),
}
SCATTER_REL_TOL = 1e-6   # of the float64 sum, relative to the absolute sum


def _scatter_inputs(shape, cuda, seed=0):
    """values f32[N, C] and rows i64[N] made on the card from a seed, the
    low rows taking more lanes (a wavefront's big triangles), or every lane
    on the middle row."""
    n, c, n_rows, how = SCATTER_SHAPES[shape]
    gen = torch.Generator(device=cuda).manual_seed(seed)
    values = torch.randn((n, c), generator=gen, device=cuda)
    u = torch.rand(n, generator=gen, device=cuda)
    rows = (u * u * n_rows).to(torch.int64).clamp_max(n_rows - 1)
    if how == "one":
        rows = torch.full_like(rows, n_rows // 2)
    return values, rows, n_rows


def _hold_scatter(got, values, rows, n_rows, what, exact=None):
    """Each entry of ``got`` within SCATTER_REL_TOL of ``exact`` (by default
    the float64 sum), relative to the sum of the absolute values it adds."""
    if exact is None:
        exact = torch.zeros((n_rows, values.shape[1]), dtype=torch.float64,
                            device=values.device).index_add_(
                                0, rows, values.double())
    scale = torch.zeros_like(exact).index_add_(0, rows, values.double().abs())
    err = (got.double() - exact).abs()
    assert bool((err <= SCATTER_REL_TOL * scale).all()), (
        what, float((err / scale.clamp_min(1e-30)).max()))


@pytest.mark.parametrize("shape", sorted(SCATTER_SHAPES))
def test_scatter_rows_kernel_equals_its_order_model(cuda, shape):
    """The kernel gives its order's model bit for bit on each path, is
    within the bound of the float64 sum and of its plain version (a float64
    bincount rounded once); one launch a call (none with no lanes); a
    strided [N, C] view, as TakeColumns passes, gives the contiguous copy's
    bits."""
    from pathtracerpython_tpu_torch.ops import gather

    values, rows, n_rows = _scatter_inputs(shape, cuda)
    before = gather.LAUNCHES
    got = gather.scatter_rows(values, rows, n_rows)
    assert gather.LAUNCHES == before + (1 if rows.numel() else 0)
    assert got.shape == (n_rows, values.shape[1])
    assert got.dtype == torch.float32
    assert torch.equal(got, gather.scatter_rows_model(values, rows, n_rows))
    _hold_scatter(got, values, rows, n_rows, "kernel")
    plain = gather.scatter_rows_plain(values, rows, n_rows)
    _hold_scatter(plain, values, rows, n_rows, "plain")
    _hold_scatter(got, values, rows, n_rows, "kernel against plain",
                  exact=plain.double())
    strided = values.T.contiguous().T
    assert torch.equal(gather.scatter_rows(strided, rows, n_rows), got)


@pytest.mark.parametrize("shape", ["tripack", "rows_100096"])
def test_scatter_rows_takes_any_integer_rows(cuda, shape):
    """Rows of int64, int32 or int16 (the narrow path reads the first two
    as they are and casts the rest) give the same bits."""
    from pathtracerpython_tpu_torch.ops import gather

    values, rows, n_rows = _scatter_inputs(shape, cuda, seed=3)
    want = gather.scatter_rows(values, rows, n_rows)
    kinds = (torch.int32, torch.int16) if n_rows < 2**15 else (torch.int32,)
    for dtype in kinds:
        assert torch.equal(
            gather.scatter_rows(values, rows.to(dtype), n_rows), want), dtype


@pytest.mark.parametrize("shape", ["light_table", "tripack", "rows_100096",
                                   "narrow_edge_1017",
                                   "wide_past_narrow_1026"])
def test_scatter_rows_bit_equal_across_launches_and_streams(cuda, shape):
    """Three launches on the current stream and one on a second stream give
    the same bits, on each path."""
    from pathtracerpython_tpu_torch.ops import gather

    values, rows, n_rows = _scatter_inputs(shape, cuda, seed=1)
    runs = [gather.scatter_rows(values, rows, n_rows) for _ in range(3)]
    side = torch.cuda.Stream(device=cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        runs.append(gather.scatter_rows(values, rows, n_rows))
    torch.cuda.current_stream(cuda).wait_stream(side)
    torch.cuda.synchronize()
    for r in runs[1:]:
        assert torch.equal(r, runs[0])


@pytest.mark.parametrize("shape", ["light_table", "tripack", "rows_100096",
                                   "narrow_edge_1017",
                                   "wide_past_narrow_1026"])
def test_scatter_rows_reads_nothing_back(cuda, shape):
    """The call (on the wide path the sort too) runs clean under the sync
    debug mode "error": no host read, so no stream sync."""
    from pathtracerpython_tpu_torch.ops import gather

    values, rows, n_rows = _scatter_inputs(shape, cuda, seed=2)
    gather.scatter_rows(values, rows, n_rows)   # builds and loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gather.scatter_rows(values, rows, n_rows)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_train_step_gradients_bit_equal_across_three_runs(cuda):
    """One training step's gradients of every material, emission and
    vertex field on the Cornell stand-in (64^2, 2 spp as lanes, 3 bounces,
    3 NEE): the same bits in three runs from the same params and key, every
    table gradient through the kernel."""
    from pathtracerpython_tpu_torch.diff import (
        camera_pixel_loss,
        make_render_fn,
    )
    from pathtracerpython_tpu_torch.ops import gather

    scene = arrays.pack_scene(synthetic.cornell_box_scene(64, 64), pad_to=32,
                              device=cuda)
    cfg = RenderConfig(n_samples=2, n_bounces=3, n_light_samples=3,
                       batch_samples=True)
    with torch.no_grad():
        target = render(scene, cfg, seed=0)
    fields = ("mat_rgb", "mat_ka", "mat_kd", "light_color", "ambient",
              "tri_v0", "tri_v1", "tri_v2", "light_v0", "light_v1",
              "light_v2")
    runs = []
    for _ in range(3):
        params = {f: getattr(scene, f).detach().clone().requires_grad_(True)
                  for f in fields}
        before = gather.LAUNCHES
        camera_pixel_loss(params, scene, target, make_render_fn(cfg),
                          torch.arange(target.shape[0], device=cuda),
                          (0, 5)).backward()
        assert gather.LAUNCHES > before
        runs.append({f: p.grad for f, p in params.items()})
    for f in fields:
        assert torch.isfinite(runs[0][f]).all(), f
        assert torch.equal(runs[1][f], runs[0][f]), f
        assert torch.equal(runs[2][f], runs[0][f]), f


# csrc/threefry.cu: ops/rng.py:uniforms on the card, against its plain
# version (the int64 tensor ops) bit for bit. A key past 2^31 in both
# words; counters of the word edges and random words, int64 ones carrying
# high bits the draws must ignore; 70,001 lanes, not a multiple of a block.
RNG_KEY_SEED, RNG_SALT = 2**40 + 12345, 13
RNG_LANES = 70_001


def _rng_counters(n, dtype, cuda, seed):
    rs = np.random.default_rng(seed)
    words = rs.integers(0, 2**32, n, dtype=np.uint64)
    words[:5] = [0, 2**31 - 1, 2**31, 2**32 - 1, 1]
    if dtype is torch.int32:
        return torch.from_numpy(words.astype(np.uint32).view(np.int32)).to(
            cuda)
    high = rs.integers(-3, 4, n).astype(np.int64) << 32
    return torch.from_numpy(words.astype(np.int64) + high).to(cuda)


def _rng_bits_equal(got, want):
    assert got.dtype == want.dtype == torch.float32
    assert got.shape == want.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n_draws", [1, 2, 3, 5, 9, 15])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_threefry_kernel_matches_plain(cuda, dtype, n_draws):
    from pathtracerpython_tpu_torch.ops import rng

    k0, k1 = rng.fold(*rng.key_from_seed(RNG_KEY_SEED), RNG_SALT)
    assert k0 >= 2**31 or k1 >= 2**31
    counters = _rng_counters(RNG_LANES, dtype, cuda, seed=n_draws)
    before = rng.LAUNCHES
    got = rng.uniforms(k0, k1, counters, n_draws)
    assert rng.LAUNCHES == before + 1
    assert got.device.type == "cuda"
    _rng_bits_equal(got, rng.uniforms_plain(k0, k1, counters, n_draws))


@pytest.mark.parametrize("layout", ["strided", "transposed_2d",
                                    "past_one_wave"])
def test_threefry_kernel_layouts_match_plain(cuda, layout):
    """Counters read in place at their strides, the output
    [n_draws, *counters.shape]; past one wave of the grid (1056 blocks of
    256 threads) the grid-stride loop takes more than one counter a
    thread."""
    from pathtracerpython_tpu_torch.ops import rng

    k0, k1 = rng.fold(*rng.key_from_seed(RNG_KEY_SEED), RNG_SALT + 1)
    if layout == "strided":
        counters = _rng_counters(3 * RNG_LANES, torch.int64, cuda, 5)[::3]
    elif layout == "transposed_2d":
        counters = _rng_counters(300 * 233, torch.int32, cuda, 6).reshape(
            300, 233).T
    else:
        counters = _rng_counters(1_000_003, torch.int64, cuda, 7)
    assert layout == "past_one_wave" or not counters.is_contiguous()
    before = rng.LAUNCHES
    got = rng.uniforms(k0, k1, counters, 15)
    assert rng.LAUNCHES == before + 1
    assert tuple(got.shape) == (15, *counters.shape)
    _rng_bits_equal(got, rng.uniforms_plain(k0, k1, counters, 15))


def test_threefry_kernel_no_counters_launches_nothing(cuda):
    from pathtracerpython_tpu_torch.ops import rng

    before = rng.LAUNCHES
    got = rng.uniforms(1, 2, torch.zeros(0, dtype=torch.int64, device=cuda),
                       15)
    assert rng.LAUNCHES == before
    assert tuple(got.shape) == (15, 0) and got.device.type == "cuda"


def test_threefry_kernel_reads_nothing_back(cuda):
    """One launch a call, on the current stream, with no stream sync: the
    call runs clean under the sync debug mode "error", and a launch on a
    second stream gives the same bits."""
    from pathtracerpython_tpu_torch.ops import rng

    counters = _rng_counters(RNG_LANES, torch.int64, cuda, seed=8)
    want = rng.uniforms(3, 4, counters, 15)   # builds and loads
    torch.cuda.synchronize()
    before = rng.LAUNCHES
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = rng.uniforms(3, 4, counters, 15)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        on_side = rng.uniforms(3, 4, counters, 15)
    torch.cuda.current_stream(cuda).wait_stream(side)
    torch.cuda.synchronize()
    assert rng.LAUNCHES == before + 2
    _rng_bits_equal(got, want)
    _rng_bits_equal(on_side, want)


def test_render_with_the_threefry_kernel_bit_equals_the_plain_draws(
        cuda, monkeypatch):
    """A 64^2 Cornell render on the card, 4 spp, 4 bounces: with the kernel
    (2 launches a bounce) and with ``rng.uniforms`` patched to the plain
    path, the same radiance bit for bit."""
    from pathtracerpython_tpu_torch.ops import rng

    scene = arrays.pack_scene(synthetic.cornell_box_scene(64, 64), pad_to=32,
                              device=cuda)
    cfg = RenderConfig(n_samples=4, n_bounces=4, batch_samples=True)
    before = rng.LAUNCHES
    with_kernel = render(scene, cfg, seed=11)
    assert rng.LAUNCHES == before + 2 * 4
    monkeypatch.setattr(rng, "uniforms", rng.uniforms_plain)
    plain = render(scene, cfg, seed=11)
    assert rng.LAUNCHES == before + 2 * 4
    assert torch.equal(with_kernel, plain)
