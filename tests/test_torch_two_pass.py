"""The two-pass protocol of the uncached cluster sweeps (``kernels/sparse.py``:
``two_pass=`` / ``m_div=`` of K5's and K6's entries, ``truncate_lists``,
``lane_unseen_bound``, the finality test ``two_pass_flags_plain``, the
compaction ``select_compact_plain``) on the CPU, where every step is its plain
version, against the JAX package's ``kernels/sparse_pallas.py``: its
``candidate_worklist(..., trunc_k=)``, ``_lane_unseen_bound``,
``_compact_select`` and ``_resolve_two_pass`` called directly (its two-pass
sweeps, with the Pallas kernels in interpret mode, are held in
tests/test_torch_two_pass_jax.py; the compaction, the parked gather and the
scatter-back in tests/test_torch_select_compact.py). The select-and-compact
kernel itself (``csrc/two_pass.cu``) runs on the card
(``tests/test_torch_cuda.py``).

Tolerances: the port's lists, drops and bounds are the JAX package's bit
for bit; two passes give the one-pass result bit for bit (winners, t,
occlusion bits and the nearest sweep's gradients) and a render with the
auto flags on the default render's radiance."""

import ctypes
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.kernels import sparse_pallas as sp
from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu_torch.kernels import build, intersect, sparse
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.ops.geometry import normalize3
from pathtracerpython_tpu_torch.ops.sort import (
    PARK_DIR,
    PARK_ORIGIN,
    scene_bounds,
    wavefront_sort_order,
)
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import render
from pathtracerpython_tpu_torch.scene import arrays, synthetic
from torch_parity import field_rays, to_jax_desc

# 1,920 triangles in 16 clusters: more than PASS1_K + LANE_M, so the
# drops past the lane-exact ones have a block key of their own
FIELD_BOXES = 160
SIZE = 48
R_BLKS = (sparse.R_BLK, sparse.R_BLK_HYBRID_NEAREST)
SMALL, BIG_BRANCH = 1, 10**6   # m_div: pass 2 always fits / never fits


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def field():
    desc = synthetic.box_field_scene(n_boxes=FIELD_BOXES, width=SIZE,
                                     height=SIZE)
    return (arrays.pack_scene(desc, tri_order="morton", device="cpu"),
            jax_arrays.pack_scene(to_jax_desc(desc), morton_order=True))


@pytest.fixture(scope="module")
def wavefronts(field):
    """name -> (o3, d3u, parked bool[N]): the camera rays; a bounce
    wavefront (origins on the surfaces the camera rays hit, so inside many
    clusters' boxes with block keys 0; random directions; sorted as the
    integrator sorts; the lanes whose camera ray missed parked at the end);
    random rays with two parked runs."""
    scene, _ = field
    po, pd = make_primary_rays(scene.eye, scene.ortho, SIZE, SIZE)
    o3 = po.T.contiguous()
    d3u = normalize3(pd.T.contiguous())
    t, idx = sparse.sparse_nearest_t_idx_cm(o3, d3u, scene)
    alive = idx >= 0
    rs = np.random.default_rng(5)
    dirs = normalize3(torch.from_numpy(
        rs.normal(size=(3, o3.shape[1])).astype(np.float32)))
    ob, db = o3 + d3u * t[None], dirs
    order = wavefront_sort_order(ob, db, alive, *scene_bounds(scene))
    ob, db, alive = ob[:, order], db[:, order], alive[order]
    ob = torch.where(alive, ob, torch.tensor(PARK_ORIGIN)[:, None])
    db = torch.where(alive, db, torch.tensor(PARK_DIR)[:, None])
    ro, rd = field_rays(2600, seed=21, parked=((0, 200), (900, 1100)))
    is_parked = lambda o: o[1] == PARK_ORIGIN[1]
    return {"camera": (o3, d3u, is_parked(o3)),
            "bounce": (ob.contiguous(), db.contiguous(), is_parked(ob)),
            "random": (ro, rd, is_parked(ro))}


def _aabb8(scene):
    return sparse.cluster_aabbs(sparse.pack_for_sparse(scene))


def _jax_drops(ref, o3, d3u, r_blk, k=sparse.PASS1_K):
    """The JAX package's truncated worklist of the nearest sweep: (its
    drops as numpy, its bound ``_lane_unseen_bound`` [N])."""
    n = o3.shape[1]
    aabb8 = sp.cluster_aabbs(sp._pack_for_sparse(ref, sp.C_TRI), sp.C_TRI)
    o3p = sp._pad_repeat_last(jnp.asarray(o3.numpy()), r_blk)
    d3p = sp._pad_repeat_last(jnp.asarray(d3u.numpy()), r_blk)
    tmax = jnp.full((o3p.shape[1] // r_blk,), sp.BIG, jnp.float32)
    _, _, overflow, _, drops = sp.candidate_worklist(
        aabb8, o3p, d3p, tmax, r_blk=r_blk, maxc=sp.MAXC, w_cap=65536,
        trunc_k=k)
    assert not bool(overflow) and drops is not None
    bound = np.asarray(sp._lane_unseen_bound(o3p, d3p, aabb8, drops, r_blk))
    return [np.array(x) for x in drops], bound[:n]


def _port_drops(scene, o3, d3u, r_blk, k=sparse.PASS1_K):
    aabb8 = _aabb8(scene)
    nrb = -(-o3.shape[1] // r_blk)
    lists = sparse.block_lists(aabb8, o3, d3u,
                               torch.full((nrb,), intersect.BIG), r_blk)
    return aabb8, lists, *sparse.truncate_lists(lists, k)


def test_constants_and_auto_match_jax():
    assert sparse.PASS1_K == sp.PASS1_K == 4
    assert sparse.LANE_M == sp.LANE_M == 8
    assert sparse.M_DIV == sp.M_DIV == 2
    assert sparse.TWO_PASS_MIN == sp.TWO_PASS_MIN == 32768
    assert sparse.TWO_PASS_NEAREST_AUTO is sp.TWO_PASS_NEAREST_AUTO is False
    assert sparse.TWO_PASS_ANY_AUTO is sp.TWO_PASS_ANY_AUTO is False
    for two_pass in (None, 0, 1, 4):
        for n in (1, 32767, 32768, 10**6):
            for on in (False, True):
                assert sparse.resolve_two_pass(two_pass, n, on) == \
                    sp._resolve_two_pass(two_pass, n, on)
    with pytest.raises(ValueError, match="two_pass"):
        sparse.resolve_two_pass(-1, 10, False)


@pytest.mark.parametrize("kind", ["camera", "bounce"])
@pytest.mark.parametrize("r_blk", R_BLKS)
def test_drops_and_bound_match_jax(field, wavefronts, kind, r_blk):
    """``truncate_lists`` of the port's lists drops what
    ``candidate_worklist(..., trunc_k=4)`` drops, ids in the same order
    (ties of the block keys included: the bounce wavefront's blocks hold
    many clusters at key 0, ordered by id in both), and
    ``lane_unseen_bound`` is ``_lane_unseen_bound`` bit for bit, on the
    JAX package's drops and on its own."""
    scene, ref = field
    o3, d3u, _ = wavefronts[kind]
    jdrops, jbound = _jax_drops(ref, o3, d3u, r_blk)
    aabb8, lists, head, drops = _port_drops(scene, o3, d3u, r_blk)
    assert torch.equal(head.ncand, lists.ncand.clamp_max(4))
    for got, want in zip(drops, jdrops):
        np.testing.assert_array_equal(got.numpy(), want)
    if kind == "bounce":   # the ties that LANE_M is for
        assert (drops.keys == 0).sum() > 0
    assert (drops.far < intersect.BIG).any() and (drops.keys <
                                                  intersect.BIG).any()
    from_jax = sparse.Drops(*(torch.from_numpy(x) for x in jdrops))
    np.testing.assert_array_equal(
        sparse.lane_unseen_bound(o3, d3u, aabb8, from_jax, r_blk).numpy(),
        jbound)
    np.testing.assert_array_equal(
        sparse.lane_unseen_bound(o3, d3u, aabb8, drops, r_blk).numpy(),
        jbound)


@pytest.mark.parametrize("lane_m", [0, 8])
def test_drops_without_lane_entries_match_jax(field, wavefronts,
                                              monkeypatch, lane_m):
    """At LANE_M = 0 the bound is the block key of the first dropped slot,
    as ``candidate_worklist``'s ``next_entry``; at either LANE_M the bound
    is the JAX package's."""
    scene, ref = field
    o3, d3u, _ = wavefronts["random"]
    monkeypatch.setattr(sparse, "LANE_M", lane_m)
    monkeypatch.setattr(sp, "LANE_M", lane_m)
    r_blk = sparse.R_BLK
    aabb8, lists, _, drops = _port_drops(scene, o3, d3u, r_blk)
    assert drops.ids.shape[1] == lane_m
    got = sparse.lane_unseen_bound(o3, d3u, aabb8, drops, r_blk)
    if lane_m == 0:
        assert torch.equal(drops.far, lists.keys[:, 4])
        np.testing.assert_array_equal(
            got.numpy(), np.repeat(drops.far.numpy(), r_blk)[:o3.shape[1]])
        return
    _, jbound = _jax_drops(ref, o3, d3u, r_blk)
    np.testing.assert_array_equal(got.numpy(), jbound)


@pytest.mark.parametrize("kind", ["camera", "bounce", "random"])
def test_lane_bound_is_conservative(field, wavefronts, kind):
    """tests/test_sparse.py::test_lane_bound_is_conservative on the port:
    on every lane the bound is at most, within SLAB_EPS, the lane's own
    exact slab entry into every cluster that its block's truncated list
    dropped (a miss counts as BIG)."""
    scene, _ = field
    o3, d3u, _ = wavefronts[kind]
    r_blk = sparse.R_BLK
    aabb8, lists, head, drops = _port_drops(scene, o3, d3u, r_blk)
    bound = sparse.lane_unseen_bound(o3, d3u, aabb8, drops, r_blk)
    hit, enter0 = sparse.lane_slab(aabb8[:, None, :], o3[:, None, :],
                                   sparse.lane_inv(d3u)[:, None, :])
    entry = torch.where(hit, enter0, intersect.BIG)           # [C, N]
    nrb, c = lists.ids.shape
    kept = torch.zeros(nrb, c, dtype=torch.bool)
    slots = torch.arange(c)[None, :] < head.ncand[:, None]
    kept.scatter_(1, lists.ids.to(torch.int64), slots)
    block = torch.arange(o3.shape[1]) // r_blk
    unseen = torch.where(kept[block].T, intersect.BIG, entry).amin(dim=0)
    assert (bound <= unseen + sparse.SLAB_EPS).all()
    assert (bound < intersect.BIG).any()


def test_parked_lanes_are_final(field, wavefronts):
    """Parked lanes (and any ray that misses the scene's box) are final in
    the port's finality test. The JAX package's nearest test (``ne < t1 +
    SLAB_EPS``, sparse_pallas.py:1993) marks a parked lane unfinished
    wherever its block's list goes on past the lane-exact drops, the park
    edge: t1 is BIG, and so is ne only where ``far`` is. Its any-hit test
    marks one where ``far`` is 0 (maxd 0 + SLAB_EPS)."""
    scene, ref = field
    o3, d3u, parked = wavefronts["bounce"]
    r_blk = sparse.R_BLK
    jdrops, jbound = _jax_drops(ref, o3, d3u, r_blk)
    big = np.float32(sp.BIG)
    eps = np.float32(sp.SLAB_EPS)
    assert big + eps == big     # the JAX test on a miss is ne < BIG
    jax_nearest = (jbound < big + eps) & parked.numpy()
    jax_any = (jbound < np.float32(0.0) + eps) & parked.numpy()
    print(f"parked lanes {int(parked.sum())}: the JAX finality marks "
          f"{int(jax_nearest.sum())} unfinished (nearest), "
          f"{int(jax_any.sum())} (any-hit)")
    assert jax_nearest.sum() > 0
    aabb8, _, _, drops = _port_drops(scene, o3, d3u, r_blk)
    t = torch.zeros(o3.shape[1])
    idx = torch.full((o3.shape[1],), -1, dtype=torch.int32)
    flags, ne = sparse.nearest_select(o3, d3u, aabb8, drops, r_blk, t, idx,
                                      want_ne=True)
    np.testing.assert_array_equal(ne.numpy(), jbound)
    assert not flags[parked].any()
    maxd = torch.where(parked, 0.0, 5.0)
    flags_any, _ = sparse.any_hit_select(
        o3, d3u, maxd, torch.zeros_like(parked), aabb8, drops, r_blk)
    assert not flags_any[parked].any()
    # the live lanes' flags are the JAX package's test, which they pass
    live = ~parked
    assert torch.equal(flags[live], torch.from_numpy(jbound < big)[live])


def test_select_matches_compact_select():
    """``select_compact_plain``'s slots and count are ``_compact_select``'s
    (the slots up to the count or the cap), and ``pass2_size`` is
    ``_pass2_size``."""
    rs = np.random.default_rng(3)
    for n, share, m in ((1000, 0.3, 512), (1000, 0.8, 512), (10, 0.0, 8)):
        unfinished = rs.uniform(size=n) < share
        o3 = torch.zeros(3, n)
        s = sparse.select_compact_plain(torch.from_numpy(unfinished), m, o3,
                                        o3)
        cnt = int(s.count[0])
        jsel, jcnt = sp._compact_select(jnp.asarray(unfinished), m)
        assert cnt == int(jcnt)
        assert bool(s.taken[0]) == (cnt > m)
        if cnt <= m:
            np.testing.assert_array_equal(s.sel[:cnt].numpy(),
                                          np.asarray(jsel)[:cnt])
        else:
            assert (s.sel == n).all()   # the fallback: every slot parked
    for n, r_blk, m_div in ((1000, 512, 2), (700, 256, 10**6), (1, 512, 2),
                            (2**20, 1024, 2)):
        n_pad = -(-n // r_blk) * r_blk
        assert sparse.pass2_size(n, r_blk, m_div) == sp._pass2_size(
            n_pad, r_blk, m_div)


class _Branches:
    """Spies on ``select_compact_plain``, the compaction that the CPU
    runs: each call's (count, cap), read from its count and its ``taken``
    word, which must agree."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = sparse.select_compact_plain

        def spy(unfinished, m, *args, **kw):
            s = real(unfinished, m, *args, **kw)
            cnt = int(s.count[0])
            assert bool(s.taken[0]) == (cnt > m)
            self.calls.append((cnt, m))
            return s

        monkeypatch.setattr(sparse, "select_compact_plain", spy)


@pytest.fixture(scope="module")
def one_pass(field, wavefronts):
    """The one-pass sweeps of the random wavefront: nearest per r_blk and
    the any-hit (maxd 6, parked lanes 0)."""
    scene, _ = field
    o3, d3u, parked = wavefronts["random"]
    maxd = torch.where(parked, 0.0, 6.0)
    return ({r: sparse.sparse_nearest_t_idx_cm(o3, d3u, scene, r_blk=r,
                                               two_pass=0) for r in R_BLKS},
            maxd, sparse.sparse_any_hit_cm(o3, d3u, maxd, scene, two_pass=0))


@pytest.mark.parametrize("m_div", [SMALL, BIG_BRANCH])
@pytest.mark.parametrize("lane_m", [0, 8])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("r_blk", R_BLKS)
def test_two_pass_nearest_equals_one_pass(field, wavefronts, one_pass,
                                          monkeypatch, r_blk, k, lane_m,
                                          m_div):
    scene, _ = field
    o3, d3u, _ = wavefronts["random"]
    monkeypatch.setattr(sparse, "LANE_M", lane_m)
    spy = _Branches(monkeypatch)
    t, idx = sparse.sparse_nearest_t_idx_cm(o3, d3u, scene, r_blk=r_blk,
                                            two_pass=k, m_div=m_div)
    want_t, want_idx = one_pass[0][r_blk]
    assert torch.equal(idx, want_idx) and torch.equal(t, want_t)
    (cnt, m), = spy.calls
    assert 0 < cnt <= m if m_div == SMALL else cnt > m


@pytest.mark.parametrize("m_div", [SMALL, BIG_BRANCH])
@pytest.mark.parametrize("lane_m", [0, 8])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_two_pass_any_hit_equals_one_pass(field, wavefronts, one_pass,
                                          monkeypatch, k, lane_m, m_div):
    scene, _ = field
    o3, d3u, _ = wavefronts["random"]
    monkeypatch.setattr(sparse, "LANE_M", lane_m)
    spy = _Branches(monkeypatch)
    _, maxd, want = one_pass
    occ = sparse.sparse_any_hit_cm(o3, d3u, maxd, scene, two_pass=k,
                                   m_div=m_div)
    assert torch.equal(occ, want)
    assert want.any() and not want.all()
    (cnt, m), = spy.calls
    assert 0 < cnt <= m if m_div == SMALL else cnt > m


@pytest.mark.parametrize("n", [0, 300])
def test_two_pass_short_wavefronts(field, wavefronts, n):
    """Fewer lanes than a block (one block, its tail repeating the last
    lane), and no lane at all."""
    scene, _ = field
    o3, d3u, parked = (x[..., :n].contiguous()
                       for x in wavefronts["random"])
    maxd = torch.where(parked, 0.0, 6.0)
    for r_blk in R_BLKS:
        got = sparse.sparse_nearest_t_idx_cm(o3, d3u, scene, r_blk=r_blk,
                                             two_pass=2)
        want = sparse.sparse_nearest_t_idx_cm(o3, d3u, scene, r_blk=r_blk,
                                              two_pass=0)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        assert got[0].shape == (n,)
    got = sparse.sparse_any_hit_cm(o3, d3u, maxd, scene, two_pass=2)
    assert torch.equal(got, sparse.sparse_any_hit_cm(o3, d3u, maxd, scene,
                                                     two_pass=0))


def test_two_pass_nearest_gradients_equal_one_pass(field, wavefronts):
    """The nearest form sits inside ``intersect.nearest_entry``'s sweep, so
    its backward is the one re-solve over the whole wavefront: the
    gradients of the vertices and the rays are the one-pass gradients bit
    for bit."""
    scene, _ = field
    o3, d3u, _ = (x[..., :600] for x in wavefronts["random"])

    def grads(two_pass):
        v0 = scene.tri_v0.clone().requires_grad_(True)
        o = o3.clone().requires_grad_(True)
        d = d3u.clone().requires_grad_(True)
        t, _ = sparse.sparse_nearest_t_idx_cm(
            o, d, dataclasses.replace(scene, tri_v0=v0), two_pass=two_pass,
            m_div=SMALL)
        (t * torch.linspace(0.5, 1.5, t.shape[0])).sum().backward()
        return v0.grad, o.grad, d.grad

    want = grads(0)
    got = grads(4)
    assert want[0].abs().sum() > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("accel", ["sparse", "hybrid"])
def test_render_with_the_auto_flags_equals_the_default(monkeypatch, accel):
    """A box-field render through accel="sparse" (K5 at 512 and K6) and the
    hybrid (K5 at 1024; its any-hit is the walker's, which has no two-pass
    form) with both auto flags on and TWO_PASS_MIN under the wavefront, as
    scripts/bench_large.py turns them on: the radiance of the default
    render bit for bit."""
    scene = arrays.pack_scene(synthetic.box_field_scene(
        n_boxes=FIELD_BOXES, width=16, height=16), tri_order="morton",
        device="cpu")
    cfg = RenderConfig(mode="fast", n_samples=2, n_bounces=2,
                       n_light_samples=2, batch_samples=True, accel=accel)
    want = render(scene, cfg, seed=3)
    monkeypatch.setattr(sparse, "TWO_PASS_NEAREST_AUTO", True)
    monkeypatch.setattr(sparse, "TWO_PASS_ANY_AUTO", True)
    monkeypatch.setattr(sparse, "TWO_PASS_MIN", 64)
    spy = _Branches(monkeypatch)
    got = render(scene, cfg, seed=3)
    assert torch.equal(got, want)
    # each bounce's nearest sweep, and under "sparse" each NEE sweep
    assert len(spy.calls) == (2 if accel == "hybrid" else 4)
    assert any(cnt > 0 for cnt, _ in spy.calls)


def _c_parameters(entry: str) -> list[str]:
    with open(os.path.join(build.CSRC_DIR, "two_pass.cu")) as f:
        text = f.read()
    head = text.index(f'extern "C" int {entry}(')
    body = text[text.index("(", head) + 1:text.index(")", head)]
    return [" ".join(p.split()) for p in body.split(",")]


SLOTS = ["m", "ncand", "nrb", "scratch", "sel", "count", "taken", "o2", "d2",
         "md2", "ncand_fb"]
DROPS = ["aabb8", "scene_box", "drop_ids", "drop_keys", "far", "lane_m",
         "r_blk"]


@pytest.mark.parametrize("entry,argtypes,state,tail", [
    ("ptt_two_pass_nearest_select", sparse._NEAREST_SELECT_ARGTYPES,
     ["words"], DROPS + SLOTS + ["flags_out", "ne_out"]),
    ("ptt_two_pass_any_hit_select", sparse._ANY_HIT_SELECT_ARGTYPES,
     ["occ", "maxd"], DROPS + SLOTS + ["flags_out", "ne_out"]),
    ("ptt_select_compact", sparse._COMPACT_ARGTYPES, ["flags", "maxd"],
     SLOTS),
])
def test_select_entries_match_their_argtypes(entry, argtypes, state, tail):
    """csrc/two_pass.cu's three entries take what ``_launch_select``
    passes: their parameters in the order and of the kinds of their
    ctypes argtypes."""
    params = _c_parameters(entry)
    assert len(params) == len(argtypes), params
    for decl, argtype in zip(params, argtypes):
        assert argtype is (ctypes.c_void_p if "*" in decl else ctypes.c_int)
    names = [decl.split("*")[-1].split()[-1] for decl in params]
    assert names[:3] == ["o3", "d3", "n"]
    assert names[3:3 + len(state)] == state
    assert names[3 + len(state):] == tail + ["device", "stream"]
