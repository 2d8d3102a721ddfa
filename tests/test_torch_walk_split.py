"""The split walk of the cluster nearest sweeps (K5, K3's sparse nearest,
K8; ``csrc/cluster.cuh``): each block's list is cut into segments of S
slots, each segment a unit of work that starts from the best the units
before it merged. ``sparse_nearest_plain(..., segment=S, order=...)``
models it one unit at a time, in any order of the segments; the merge is
the lexicographic (t, index) minimum, so every order must give the serial
walk's winners, and those are the JAX package's (its Pallas kernel in
interpret mode, as tests/test_sparse.py runs it; here on the "tail"
wavefront, the random rays' serial walk is held against it in
tests/test_torch_sparse.py and tests/test_torch_walker.py).

Tolerances: the split model against the serial walk bit for bit (t and
index, every lane). Against the JAX kernel the bounds the serial walk is
held to in tests/test_torch_sparse.py and tests/test_torch_plucker.py:
winners equal but on grazing lanes, t within 1e-6 (classic) or 1e-5
(Plücker: XLA:CPU fuses a product into the moments' subtraction). The
visits lie in the band of the kernels' counting instances: at least the
clusters each lane needs up to its winner's t, at most what the segments
visit when each starts from nothing."""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.kernels import intersect_pallas as ip
from pathtracerpython_tpu.kernels import sparse_pallas as sp
from pathtracerpython_tpu_torch.kernels import intersect, sparse, walker
from pathtracerpython_tpu_torch.ops.geometry import normalize3
from pathtracerpython_tpu_torch.ops.sort import PARK_DIR, PARK_ORIGIN
from pathtracerpython_tpu_torch.scene import synthetic
from torch_parity import (
    GRAZING_MARGIN,
    T_ATOL,
    T_RTOL,
    bary_margin_f64,
    pack_pair,
)

N_LANES = 1800
LIVE = 1400        # the lanes from this one on are parked
EDGE = 600         # the direction octant changes at this lane
T_RTOL_PLUCKER = 1e-5
# the lists' kinds and their blocks: K5's in blocks of 512 and 1024, K8's
LISTS = {"512": 512, "1024": 1024, "walker": walker.R_BLK}
ORDERS = ("front", "reversed", "random")


@pytest.fixture(scope="module")
def field():
    """box_field(80): 964 triangles in morton order, 8 clusters, so a list
    is at most 8 slots long and every S of 1, 2, 3 splits it."""
    return pack_pair(synthetic.box_field_scene(n_boxes=80, width=24,
                                               height=24),
                     tri_order="morton")


def _wavefront(kind: str, seed: int = 0):
    """o3, d3u f32[3, N_LANES]. "random": rays from inside the field
    in every direction (the incoherent case). "tail": the shape of the
    render's second bounce that sets the kernels' time: rays from inside the
    field, many of which miss, in one direction octant up to lane EDGE and
    in another after it (a block straddles the two, as a block of
    the octant-sorted wavefront does), and the lanes from LIVE on are
    parked at PARK_ORIGIN, as the integrator parks dead lanes last."""
    rs = np.random.default_rng(seed)
    o = rs.uniform([-8, -1, -16], [8, 1.5, 3], (N_LANES, 3)).astype(np.float32)
    d = rs.normal(size=(N_LANES, 3)).astype(np.float32)
    if kind == "tail":
        d = np.abs(d) * np.float32([1.0, -1.0, -1.0])
        d[EDGE:, 0] *= -1.0
        o[LIVE:], d[LIVE:] = PARK_ORIGIN, PARK_DIR
    o3 = torch.from_numpy(np.ascontiguousarray(o.T))
    return o3, normalize3(torch.from_numpy(np.ascontiguousarray(d.T)))


def _lists(scene, o3, d3u, which):
    aabb8 = sparse.cluster_aabbs(sparse.pack_for_sparse(scene))
    if which == "walker":
        return aabb8, walker.nearest_lists(aabb8, o3, d3u)
    r_blk = LISTS[which]
    nrb = -(-o3.shape[1] // r_blk)
    return aabb8, sparse.block_lists(aabb8, o3, d3u,
                                     torch.full((nrb,), intersect.BIG), r_blk)


def _pack(scene, form):
    if form == "plucker":
        return intersect.scene_plucker_pack(scene, sparse.PACK_ROWS)
    return sparse.pack_for_sparse(scene)


def _order(how: str, n_seg: int):
    if how == "front":
        return None
    if how == "reversed":
        return list(range(n_seg))[::-1]
    return np.random.default_rng(7).permutation(n_seg).tolist()


@contextlib.contextmanager
def _jax_form(form):
    saved = ip.MT_IMPL
    ip.MT_IMPL = form
    try:
        yield
    finally:
        ip.MT_IMPL = saved


_JAX = {}


def _jax_winners(ref, form):
    """The JAX kernel's (t, idx) on the "tail" wavefront as numpy, once per
    form: the sparse kernel in blocks of 1024 as tests/test_torch_sparse.py
    runs it. Its winners are the function every list kind computes: the
    port's walks at 512, 1024 and on the walker's lists and the dense sweep
    agree bit for bit, and the JAX walker kernel is held to them in
    tests/test_torch_walker.py. ``chunk_rb``, the ray blocks of one launch,
    is cut to the wavefront's: it only pads the launch (interpret mode pays
    for every padded block) and changes no result."""
    if form not in _JAX:
        o3, d3u = (jnp.asarray(x.numpy()) for x in _wavefront("tail"))
        with _jax_form(form):
            out = sp.sparse_nearest_t_idx_cm(
                o3, d3u, ref, r_blk=1024, w_per_rb=sp.W_PER_RB_HYBRID_NEAREST,
                chunk_rb=2)
        _JAX[form] = tuple(np.asarray(x) for x in out)
    return _JAX[form]


def _assert_jax_winners(scene, o3, d3u, t, idx, want, form):
    jt, jidx = want
    t, idx = t.numpy(), idx.numpy()
    same = idx == jidx
    bad = np.nonzero(~same)[0]
    assert len(bad) <= 0.01 * len(idx), f"{len(bad)} winner mismatches"
    tri = [scene.tri_v0.numpy(), scene.tri_v1.numpy(), scene.tri_v2.numpy()]
    o_np, d_np = o3.numpy(), d3u.numpy()
    margin = GRAZING_MARGIN if form == "classic" else 1e-4
    for r in bad:
        margins = [abs(bary_margin_f64(tri[0][i], tri[1][i], tri[2][i],
                                       o_np[:, r], d_np[:, r]))
                   for i in (idx[r], jidx[r]) if i >= 0]
        assert margins and min(margins) < margin, (r, margins)
    rtol = T_RTOL if form == "classic" else T_RTOL_PLUCKER
    np.testing.assert_allclose(t[same], jt[same], rtol=rtol, atol=T_ATOL)


# (wavefront, lists, form, segment length, order of the segments): on the
# "tail" wavefront every combination; on the random one each segment length
# once per lists and form, each with another order
FORMS = {"512": ("classic", "plucker"), "1024": ("classic", "plucker"),
         "walker": ("classic",)}    # K8 has no Plücker form
CASES = [("tail", which, form, segment, order) for which in LISTS
         for form in FORMS[which] for segment in (1, 2, 3)
         for order in ORDERS] + [
    ("random", which, form, segment, ORDERS[segment - 1])
    for which in LISTS for form in FORMS[which] for segment in (1, 2, 3)]
_SERIAL = {}


def _serial(field, kind, which, form):
    """The inputs of one case and what its split walks are held to: the
    serial walk's (t, idx) and visits, and the visits' band per segment
    length (filled by the tests), once per wavefront, lists and form."""
    key = (kind, which, form)
    if key not in _SERIAL:
        scene, _ = field
        o3, d3u = _wavefront(kind)
        aabb8, lists = _lists(scene, o3, d3u, which)
        r_blk = LISTS[which]
        pack = _pack(scene, form)
        pair = intersect.PLUCKER if form == "plucker" else intersect.CLASSIC
        visits = []
        t, idx = sparse.sparse_nearest_plain(o3, d3u, pack, aabb8, lists,
                                             r_blk, visits, pair)
        _SERIAL[key] = dict(
            rays=(o3, d3u), walk=(pack, aabb8, lists, r_blk), pair=pair,
            t=t, idx=idx, visits=int(sum(int(v) for v in visits)), band={})
    return _SERIAL[key]


@pytest.mark.parametrize("kind,which,form,segment,order", CASES)
def test_split_walk_equals_serial_walk_and_jax(field, kind, which, form,
                                               segment, order):
    case = _serial(field, kind, which, form)
    o3, d3u = case["rays"]
    pack, aabb8, lists, r_blk = case["walk"]
    n_seg = -(-int(lists.ncand.max()) // segment)
    assert n_seg > 1   # every long list splits
    visits = []
    t, idx = sparse.sparse_nearest_plain(
        o3, d3u, pack, aabb8, lists, r_blk, visits, case["pair"],
        segment=segment, order=_order(order, n_seg))
    assert torch.equal(idx, case["idx"]) and torch.equal(t, case["t"])
    if kind == "tail":
        _assert_jax_winners(field[0], o3, d3u, t, idx,
                            _jax_winners(field[1], form), form)
    assert (idx >= 0).any() and (idx < 0).any()
    # the visits' band
    n_visits = int(sum(int(v) for v in visits))
    if segment not in case["band"]:
        case["band"][segment] = sparse.walk_visit_band(
            o3, d3u, pack, aabb8, lists, r_blk, t, idx, segment,
            case["pair"])
    floor, ceiling = case["band"][segment]
    assert 0 < floor <= n_visits <= ceiling
    assert floor <= case["visits"] <= ceiling
    if order == "front":
        # each segment starts from the serial walk's bound at its slot
        assert n_visits == case["visits"]


@pytest.mark.parametrize("which", list(LISTS))
def test_tail_wavefront_holds_the_causes_of_long_walks(field, which):
    """The "tail" wavefront has what the render's second bounce has: blocks
    with a live lane that misses (its bound stays BIG, so its block never
    stops), a block whose lanes straddle two direction octants and a block
    that holds the park edge; the latter two list every cluster."""
    scene, _ = field
    o3, d3u = _wavefront("tail")
    aabb8, lists = _lists(scene, o3, d3u, which)
    r_blk = LISTS[which]
    t, idx = sparse.sparse_nearest_plain(o3, d3u, sparse.pack_for_sparse(
        scene), aabb8, lists, r_blk)
    live = torch.arange(N_LANES) < LIVE
    misses = sparse.pad_repeat_last((idx < 0) & live, r_blk).reshape(
        -1, r_blk)
    assert int(misses.any(dim=1).sum()) >= 2
    octant = ((d3u > 0).long() * torch.tensor([[1], [2], [4]])).sum(dim=0)
    edge = slice(EDGE // r_blk * r_blk, (EDGE // r_blk + 1) * r_blk)
    assert len(set(octant[edge][live[edge]].tolist())) == 2
    park = slice(LIVE // r_blk * r_blk, (LIVE // r_blk + 1) * r_blk)
    assert live[park].any() and not live[park].all()
    for lane in (EDGE, LIVE):
        assert int(lists.ncand[lane // r_blk]) == aabb8.shape[0]
        assert float(lists.keys[lane // r_blk, 0]) == 0.0


@pytest.mark.parametrize("which", list(LISTS))
def test_one_segment_per_list_is_the_serial_walk(field, which):
    """A segment as long as the longest list: one unit a block, the serial
    walk visit for visit."""
    scene, _ = field
    o3, d3u = _wavefront("tail")
    aabb8, lists = _lists(scene, o3, d3u, which)
    pack = sparse.pack_for_sparse(scene)
    serial, split = [], []
    want = sparse.sparse_nearest_plain(o3, d3u, pack, aabb8, lists,
                                       LISTS[which], serial)
    got = sparse.sparse_nearest_plain(o3, d3u, pack, aabb8, lists,
                                      LISTS[which], split,
                                      segment=aabb8.shape[0])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert [int(v) for v in split] == [int(v) for v in serial]


def test_segment_slots():
    assert sparse.segment_slots(7, None) == [range(0, 7)]
    assert sparse.segment_slots(7, 3) == [range(0, 3), range(3, 6),
                                          range(6, 7)]
    assert sparse.segment_slots(7, 3, [5, 2, 0, 1]) == [
        range(6, 7), range(0, 3), range(3, 6)]
    assert sparse.segment_slots(0, None) == []
