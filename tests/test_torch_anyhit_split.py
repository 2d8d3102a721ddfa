"""The split any-hit walk of the cluster shadow sweeps (K6, K3's sparse
any-hit, K9, K7; ``csrc/any_hit_walk.cuh``) and its in-cluster box cull:
``any_hit_walk(..., cull=, segment=, order=, merge=)`` models the kernels,
each block's list cut into segments of S slots walked in any order, each
visited cluster's rows culled by span, mid and group boxes
(``cluster_cull_boxes``). K6 and K9 merge by occlusion marks: a segment
starts with the lanes the segments before it left unoccluded. K7 merges by
each lane's first blocking slot: a segment starts with the lanes that no
smaller slot has blocked. Occlusion is an OR over the slots, so every order
must give the serial walk's bits, culled or not, and those are the JAX
package's (its Pallas kernels in interpret mode, as
tests/test_torch_sparse_anyhit.py and tests/test_torch_walker.py run
them); under K7's merge every order must also give the serial walk's
first blocking cluster, which K6's merge does not (the negative control).
K7's clusters are held against the JAX kernel's in
tests/test_torch_nee_cache.py, at the JAX package's blocks of 512: a
lane's first blocking slot depends on its block's list, its bits do not.

Tolerance: none. The field's triangles are axis-aligned, so no pair test
is ill-conditioned and the culled walk, the un-culled serial walk and the
JAX kernels agree bit for bit on every lane, and the walks' clusters
cluster for cluster. The counts of a walk lie in
the band of ``any_hit_visit_band`` (at least what every timing of the
kernels' units counts, at most what their segments count when each starts
with every lane open), and the pairs tested are at most C_TRI per visit
through the gate."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.kernels import intersect_pallas as ip
from pathtracerpython_tpu.kernels import sparse_pallas as sp
from pathtracerpython_tpu.kernels import walker_pallas as wk
from pathtracerpython_tpu_torch.kernels import intersect, sparse, walker
from pathtracerpython_tpu_torch.ops.geometry import normalize3
from pathtracerpython_tpu_torch.ops.sort import PARK_DIR, PARK_ORIGIN
from pathtracerpython_tpu_torch.scene import arrays, synthetic
from torch_parity import pack_pair

# The wavefront: three parts of PART lanes (mixed, occluded, open); lanes
# PARKED of the mixed part are parked with maxd = 0. A lane's bits do not
# depend on its block, so the walks run on blocks of PART lanes (K6's
# lists, classic and Plücker) and of the whole wavefront (a walker block
# holds the parts together), smaller than the kernels' 512 and 1280: every
# PyTorch op of a walk then stays under the size that PyTorch splits over
# threads, which costs more than the op where tests share the cores.
PART = 64
PARKED = (20, 30)
# the kinds: (JAX any-hit the walks are held to, form, lanes a block); K7
# ("cached") walks K6's lists with its own merge
KINDS = {"sparse": ("sparse", "classic", PART),
         "plucker": ("sparse", "plucker", PART),
         "walker": ("walker", "classic", 3 * PART),
         "cached": ("sparse", "classic", PART)}
MERGES = {"cached": "first_slot"}   # the others: "mark"
# (kind, S, order): each segment length once per kind, each with an order
SPLITS = [(kind, segment, order) for kind in KINDS
          for segment, order in ((8, "random"), (16, "reversed"),
                                 (32, "random"))]


@pytest.fixture(scope="module")
def field():
    """box_field(400): 4,804 triangles in morton order, 40 clusters, so a
    list is up to 38 slots long and S = 8, 16 and 32 all split it."""
    return pack_pair(synthetic.box_field_scene(n_boxes=400, width=24,
                                               height=24),
                     tri_order="morton")


def _wavefront(block: int = PART):
    """o3, d3u f32[3, 3 * block], maxd f32[3 * block] in three parts. Mixed:
    random rays inside the field with windows of 0.5 to 8 units, some
    occluded, lanes PARKED parked. Occluded: rays from above the boxes
    straight down to the floor within their window, so every lane is
    occluded. Open: random rays inside the field with windows of 0.002,
    which reach clusters but no occluder."""
    rs = np.random.default_rng(0)
    mixed = rs.uniform([-8, -1, -16], [8, 1.5, 3], (block, 3))
    d_mixed = rs.normal(size=(block, 3))
    md_mixed = rs.uniform(0.5, 8.0, block)
    lo, hi = PARKED
    mixed[lo:hi], d_mixed[lo:hi], md_mixed[lo:hi] = PARK_ORIGIN, PARK_DIR, 0
    down = np.stack([rs.uniform(-7.5, 7.5, block), np.full(block, 1.2),
                     rs.uniform(-15.5, 0.0, block)], axis=1)
    d_down = np.tile([0.0, -1.0, 0.0], (block, 1))
    near = rs.uniform([-8, -1, -16], [8, 1.5, 3], (block, 3))
    d_near = rs.normal(size=(block, 3))
    o = np.concatenate([mixed, down, near]).astype(np.float32)
    d = np.concatenate([d_mixed, d_down, d_near]).astype(np.float32)
    maxd = np.concatenate([md_mixed, np.full(block, 5.0),
                           np.full(block, 0.002)]).astype(np.float32)
    o3 = torch.from_numpy(np.ascontiguousarray(o.T))
    d3u = normalize3(torch.from_numpy(np.ascontiguousarray(d.T)))
    return o3, d3u, torch.from_numpy(maxd)


@contextlib.contextmanager
def _jax_form(form):
    saved = ip.MT_IMPL
    ip.MT_IMPL = form
    try:
        yield
    finally:
        ip.MT_IMPL = saved


_CASES = {}
_JAX = {}


def _jax_bits(ref, jax_sweep, form, rays):
    """The JAX any-hit's bits, once per sweep and form."""
    if (jax_sweep, form) not in _JAX:
        jrays = [jnp.asarray(x.numpy()) for x in rays]
        if jax_sweep == "walker":
            bits = wk.walker_any_hit_cm(*jrays, ref)
        else:
            with _jax_form(form):
                bits = sp.sparse_any_hit_cm(*jrays, ref)
        _JAX[jax_sweep, form] = torch.from_numpy(np.array(bits))
    return _JAX[jax_sweep, form]


def _case(field, kind):
    """The inputs of a kind's walks and what they are held to, once per
    kind: the serial un-culled walk's bits and clusters, the culled serial
    walk's bits, clusters and counts, and the JAX kernel's bits."""
    if kind not in _CASES:
        scene, ref = field
        jax_sweep, form, r_blk = KINDS[kind]
        o3, d3u, maxd = _wavefront()
        tripack = sparse.pack_for_sparse(scene)
        aabb8 = sparse.cluster_aabbs(tripack)
        lists = sparse.window_lists(aabb8, o3, d3u, maxd, r_blk)
        plucker = form == "plucker"
        pack = (intersect.scene_plucker_pack(scene, sparse.PACK_ROWS)
                if plucker else tripack)
        pair = intersect.PLUCKER if plucker else intersect.CLASSIC
        walk = (o3, d3u, maxd, pack, aabb8, lists, r_blk)
        cull = sparse.scene_cluster_cull_boxes(scene)
        serial, serial_cl = sparse.any_hit_walk(*walk, pair=pair)
        counts, visits = {}, []
        culled, culled_cl = sparse.any_hit_walk(*walk, visits, pair,
                                                cull=cull, counts=counts)
        _CASES[kind] = dict(walk=walk, pair=pair, cull=cull, serial=serial,
                            serial_cl=serial_cl, culled=culled,
                            culled_cl=culled_cl, counts=counts,
                            gate=int(sum(int(v) for v in visits)),
                            jax=_jax_bits(ref, jax_sweep, form,
                                          (o3, d3u, maxd)),
                            merge=MERGES.get(kind, "mark"), bands={})
    return _CASES[kind]


def _band(case, segment):
    if segment not in case["bands"]:
        case["bands"][segment] = sparse.any_hit_visit_band(
            *case["walk"], case["culled"], segment, case["pair"],
            case["cull"])
    return case["bands"][segment]


@pytest.mark.parametrize("kind", KINDS)
def test_culled_walk_equals_serial_walk_and_jax(field, kind):
    case = _case(field, kind)
    culled = case["culled"]
    assert torch.equal(culled, case["serial"])
    assert torch.equal(culled, case["jax"])
    # the cull changes which row of a cluster blocks first, not whether the
    # cluster blocks a conditioned lane
    assert torch.equal(case["culled_cl"], case["serial_cl"])
    mixed, down, near = culled.reshape(3, -1)
    assert 0.05 < mixed.float().mean().item() < 0.95
    assert int(case["walk"][5].ncand.max()) > 32   # S = 32 splits it
    assert not bool(mixed[PARKED[0]:PARKED[1]].any())
    assert bool(down.all()) and not bool(near.any())
    # the cull tests a small share of the pairs the gate lets through
    counts = case["counts"]
    assert counts["visits"] == case["gate"]
    assert 0 < counts["pairs_tested"] <= sparse.C_TRI * counts["visits"]
    assert counts["span_tests"] <= 4 * counts["visits"]
    assert counts["mid_tests"] <= 4 * counts["span_tests"]
    assert counts["group_tests"] <= 4 * counts["mid_tests"]
    floor, ceiling = _band(case, sparse.ANY_HIT_SEGMENT)["visits"]
    assert floor <= counts["visits"] <= ceiling


@pytest.mark.parametrize("kind,segment,order", SPLITS)
def test_split_walk_in_any_order_equals_serial_walk(field, kind, segment,
                                                    order):
    case = _case(field, kind)
    o3, d3u, maxd, pack, aabb8, lists, r_blk = case["walk"]
    n_seg = -(-int(lists.ncand.max()) // segment)
    assert n_seg > 1   # every long list splits
    seq = list(range(n_seg))[::-1] if order == "reversed" else (
        np.random.default_rng(segment).permutation(n_seg).tolist())
    counts, visits = {}, []
    occ, blocked = sparse.any_hit_walk(
        o3, d3u, maxd, pack, aabb8, lists, r_blk, visits, case["pair"],
        cull=case["cull"], segment=segment, order=seq, counts=counts,
        merge=case["merge"])
    assert torch.equal(occ, case["culled"])
    # an occluded lane names the cluster that blocked it, an open one none
    assert bool(((blocked >= 0) == occ).all())
    if case["merge"] == "first_slot":
        # K7: the first blocking cluster in list order, whatever the order
        assert torch.equal(blocked, case["serial_cl"])
    for key, (floor, ceiling) in _band(case, segment).items():
        assert floor <= counts[key] <= ceiling, (key, counts[key])
        assert floor <= case["counts"][key] <= ceiling, key
    assert counts["visits"] == int(sum(int(v) for v in visits))
    assert counts["pairs_tested"] <= sparse.C_TRI * counts["visits"]


@pytest.mark.parametrize("kind", KINDS)
def test_front_to_back_segments_are_the_serial_walk(field, kind):
    """Segments taken front to back, each starting where the one before it
    left the lanes: the serial walk, count for count."""
    case = _case(field, kind)
    counts = {}
    occ, blocked = sparse.any_hit_walk(*case["walk"], pair=case["pair"],
                                       cull=case["cull"], segment=16,
                                       counts=counts, merge=case["merge"])
    assert torch.equal(occ, case["culled"]) and counts == case["counts"]
    assert torch.equal(blocked, case["culled_cl"])


@pytest.mark.parametrize("segment", [8, 32])
def test_mark_merge_names_a_later_cluster_where_first_slot_does_not(
        field, segment):
    """The negative control of K7's merge: the segments taken back to
    front, K6's rule (a segment drops every lane a segment before it
    blocked) lets a back segment's cluster stand on a lane that a front
    segment also blocks; K7's rule (drop only on a smaller slot) keeps the
    front one. The bits are the same under both."""
    case = _case(field, "cached")
    lists = case["walk"][5]
    n_seg = -(-int(lists.ncand.max()) // segment)
    back_to_front = list(range(n_seg))[::-1]
    got = {merge: sparse.any_hit_walk(*case["walk"], pair=case["pair"],
                                      cull=case["cull"], segment=segment,
                                      order=back_to_front, merge=merge)
           for merge in ("mark", "first_slot")}
    want = case["serial_cl"]
    for occ, _ in got.values():
        assert torch.equal(occ, case["culled"])
    assert torch.equal(got["first_slot"][1], want)
    later = got["mark"][1] != want
    assert bool(later.any())
    # where they differ, the mark merge's cluster sits later in the list
    slot = lambda cl: _slots(lists, case["walk"][6], cl)
    assert bool((slot(got["mark"][1]) > slot(want))[later].all())


def _slots(lists, r_blk, cl):
    """Each lane's list slot of cluster ``cl`` (a lane's cluster is on its
    block's list once)."""
    ids = lists.ids.to(torch.int64).repeat_interleave(r_blk, dim=0)[
        :cl.shape[0]]
    return (ids == cl[:, None].to(torch.int64)).long().argmax(dim=1)


def test_cluster_boxes_hold_their_groups_across_the_padding():
    """A pack of 248 rows (box_field(20) padded to a multiple of 8): the
    second cluster holds rows 128-247 and 8 rows of the sparse pack's
    padding. The table's groups are the sparse pack's own group boxes
    (empty where a group holds no valid occluder), the spans and mids their
    unions; the culled walk on it equals the un-culled one."""
    scene = arrays.pack_scene(synthetic.box_field_scene(n_boxes=20,
                                                        width=8, height=8),
                              pad_to=8, device="cpu")
    tripack = sparse.pack_for_sparse(scene)
    assert scene.num_padded_triangles == 248 and tripack.shape[0] == 512
    c = tripack.shape[0] // sparse.C_TRI
    boxes = sparse.scene_cluster_cull_boxes(scene)
    assert boxes.shape == (c, sparse.CLUSTER_BOXES, 8)
    spans, mids, groups = boxes.split([4, 16, 64], dim=1)
    own = intersect.grow_boxes(intersect.block_aabbs(
        tripack, intersect.CULL_GROUP, intersect.OCCLUDER_COL))
    assert torch.equal(groups.reshape(-1, 8), own)
    empty = groups[..., 0] > groups[..., 3]
    assert bool(empty[1, 60:].all()) and bool(empty[2:].all())
    assert not bool(empty[1, :60].all())
    for above, per in ((spans, 16), (mids, 4)):
        parts = groups.reshape(c, above.shape[1], per, 8)
        assert torch.equal(above[..., :3], parts[..., :3].amin(dim=2))
        assert torch.equal(above[..., 3:6], parts[..., 3:6].amax(dim=2))
    assert bool((spans[2:, :, 0] > spans[2:, :, 3]).all())
    # rays from inside the field, in blocks of 256 over both clusters
    rs = np.random.default_rng(1)
    n = 512
    o3 = torch.from_numpy(rs.uniform([-8, -1, -16], [8, 1.5, 3], (n, 3))
                          .astype(np.float32).T.copy())
    d3u = normalize3(torch.from_numpy(rs.normal(size=(3, n))
                                      .astype(np.float32)))
    maxd = torch.from_numpy(rs.uniform(0.5, 16.0, n).astype(np.float32))
    aabb8 = sparse.cluster_aabbs(tripack)
    lists = sparse.window_lists(aabb8, o3, d3u, maxd, 256)
    walk = (o3, d3u, maxd, tripack, aabb8, lists, 256)
    culled = sparse.any_hit_walk(*walk, cull=boxes, segment=1,
                                 order=[1, 0])[0]
    assert torch.equal(culled, sparse.any_hit_walk(*walk)[0])
    assert torch.equal(culled, intersect.any_hit_cm(o3, d3u, maxd, scene))
    assert bool(culled.any()) and not bool(culled.all())


def test_any_hit_stats_names_the_counters():
    stats = torch.arange(7, dtype=torch.int64)
    assert sparse.any_hit_stats(stats) == dict(zip(
        ("units_launched", "units_stopped_at_once", "visits", "span_tests",
         "mid_tests", "group_tests", "pairs_tested"), range(7)))
