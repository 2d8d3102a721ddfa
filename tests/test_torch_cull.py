"""The AABB cull of the dense occluder sweeps (K2, K4 and K3's dense
any-hit): the port's boxes and slab test against the JAX package's
``_block_aabbs`` and ``_aabb_cull_rows``, the plain model of the culled sweep
against the un-culled plain versions (the cull must not change one bit), and
against the JAX package's culled Pallas kernels in interpret mode; and the
property that makes the cull exact, for the occluder sweeps' bound and for
the nearest sweep's (``test_conditioned_hits_meet_their_boxes_at_their_own_t``;
the nearest sweep's other cases are in ``test_torch_nearest_cull.py``).

Tolerances: boxes and booleans equal; mean cosine within 1e-6 (the same
float32 sums on the same bits)."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from pathtracerpython_tpu.kernels.intersect_pallas import (
    T_BLK,
    _aabb_cull_rows,
    _any_hit_call,
    _block_aabbs,
    _pad_dim,
    any_hit_pallas_cm as jax_any_hit_pallas_cm,
    pack_triangles,
)
from pathtracerpython_tpu.kernels.nee_pallas import _light_pack, _nee_fwd_impl
from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu_torch.kernels import intersect, nee
from pathtracerpython_tpu_torch.ops import rng
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.ops.geometry import nearest_hit_cm, normalize3
from pathtracerpython_tpu_torch.render import integrator
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.scene import arrays, synthetic
from torch_parity import GRAZING_MARGIN, occlusion_margin_f64, to_jax_desc

MC_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: with one intra-op thread these tests take
    the same time alone and do not fight the other test workers for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _scene(name):
    if name == "cornell":      # one tile of 64 rows
        return arrays.pack_scene(synthetic.cornell_box_scene(32, 32),
                                 pad_to=32, device="cpu")
    if name == "boxfield40":   # 484 triangles in 512 rows: two tiles
        return arrays.pack_scene(synthetic.box_field_scene(
            n_boxes=40, width=32, height=32), pad_to=128, device="cpu")
    if name == "boxfield40 morton":
        return arrays.pack_scene(synthetic.box_field_scene(
            n_boxes=40, width=32, height=32), tri_order="morton",
            device="cpu")
    assert name == "boxfield300"
    return arrays.pack_scene(synthetic.box_field_scene(
        n_boxes=300, width=16, height=16), pad_to=128, device="cpu")


@functools.lru_cache(maxsize=None)
def _wavefronts(name, s_samples):
    """The NEE inputs of the scene's first and second bounce wavefronts
    (1,024 path lanes each), as the render forms them: [(point3, normal3,
    u_nee, shadow rays)]."""
    scene = _scene(name)
    cfg = RenderConfig(n_samples=1, n_bounces=2, n_light_samples=s_samples,
                       batch_samples=True)
    w, h = scene.meta.width, scene.meta.height
    origins, dirs = make_primary_rays(scene.eye, scene.ortho, w, h)
    state = integrator.init_rays(origins.T.contiguous(), dirs.T.contiguous(),
                                 torch.arange(w * h))
    k0, k1 = rng.key_from_seed(0)
    out = []
    for b in range(2):
        st_, o3, d3 = integrator.sort_and_park(state, None)
        nk = rng.fold(k0, k1, b * 4 + integrator._P_NEE)
        u_nee = rng.uniforms(*nk, st_.counters, s_samples * 5)
        hit = nearest_hit_cm(o3, d3, scene)
        shading = integrator.arrival_side_normal(
            hit.normal3, normalize3(st_.direction3))
        shadow = integrator.nee_shadow_rays(
            hit, u_nee, scene, cfg, shading,
            st_.alive & hit.hit & ~hit.is_light, st_.nee_occ_hint)
        out.append((hit.point3.contiguous(), shading.contiguous(),
                    u_nee.contiguous(), shadow))
        state = integrator.bounce_step(state, b, scene, cfg, k0, k1, None)
    return out


# (a) the boxes


def _pack_with_hole():
    """The 40-box pack with rows 256..511 invalid: an empty second block."""
    tripack = intersect.scene_tripack(_scene("boxfield40")).clone()
    tripack[256:, 9] = 0.0
    return tripack


@pytest.mark.parametrize("name,block", [("boxfield300", 256),
                                        ("boxfield300", 512), ("hole", 256)])
def test_block_aabbs_equals_jax(name, block):
    tripack = (_pack_with_hole() if name == "hole"
               else intersect.scene_tripack(_scene(name)))
    got = intersect.block_aabbs(tripack, block).numpy()
    padded = _pad_dim(jnp.asarray(tripack.numpy()), block, axis=0)
    want = np.asarray(_block_aabbs(padded, block))[:, 0, :]
    assert got.shape == want.shape == (-(-tripack.shape[0] // block), 8)
    assert got.tobytes() == want.tobytes()
    if name == "hole":
        assert (got[1, 0:3] > got[1, 3:6]).all()   # inverted: never met
        hit, nonempty = intersect.aabb_cull_rows(
            torch.from_numpy(got), torch.zeros(3, 1, 4), torch.ones(3, 1, 4),
            torch.full((1, 4), 50.0))
        assert nonempty[:, 0].tolist() == [True, False]


def test_occluder_boxes_cover_only_occluder_rows():
    """With the occluder column as the mask, the light's rows (valid, not
    occluders) leave the boxes; grown boxes hold the exact ones, and a box
    that holds another still does after both are grown."""
    tripack = intersect.scene_tripack(_scene("boxfield40"))
    light = (tripack[:, 9] > 0.5) & (tripack[:, 10] < 0.5)
    assert light.any()
    g = intersect.CULL_GROUP
    every = intersect.block_aabbs(tripack, g)
    occluders = intersect.block_aabbs(tripack, g, intersect.OCCLUDER_COL)
    rows = torch.nonzero(light).flatten() // g
    assert not torch.equal(every[rows], occluders[rows])
    cull = intersect.cull_boxes(tripack)
    own = intersect.grow_boxes(
        intersect.block_aabbs(tripack, 1, intersect.OCCLUDER_COL))
    nonempty = occluders[:, 0] <= occluders[:, 3]
    assert bool((cull.group[nonempty, 0:3] < occluders[nonempty, 0:3]).all())
    assert bool((cull.group[nonempty, 3:6] > occluders[nonempty, 3:6]).all())
    assert torch.equal(cull.group[~nonempty], occluders[~nonempty])
    for boxes, block in ((cull.group, g), (cull.tile, intersect.TILE_ROWS)):
        outer = boxes[torch.arange(own.shape[0]) // block]
        inner = own[:, 0] <= own[:, 3]
        assert bool((outer[inner, 0:3] <= own[inner, 0:3]).all())
        assert bool((outer[inner, 3:6] >= own[inner, 3:6]).all())


def test_cull_boxes_are_cached_per_scene():
    """A render derives the boxes once per scene, not once per bounce, and
    they share the cache with the Plücker pack."""
    scene = _scene("boxfield40")
    first = intersect.scene_cull_boxes(scene)
    assert first.tile.shape == (2, 8) and first.group.shape == (
        512 // intersect.CULL_GROUP, 8)
    assert intersect.scene_cull_boxes(scene) is first
    pack36 = intersect.scene_plucker_pack(scene)
    assert intersect.scene_plucker_pack(scene) is pack36
    assert intersect.scene_cull_boxes(scene) is first   # both stay cached
    other = _scene("boxfield40 morton")
    assert intersect.scene_cull_boxes(other) is not first
    assert intersect.scene_cull_boxes(scene) is not first  # one scene is kept


# (b) the slab test


def _cull_rays(box, seed):
    """4,096 random rays around ``box`` plus rays parallel to an axis, with
    zero components, and with origins on a face of the box."""
    rs = np.random.default_rng(seed)
    lo, hi = box[0:3], box[3:6]
    if lo[0] > hi[0]:
        lo, hi = -np.ones(3, np.float32), np.ones(3, np.float32)
    span = np.maximum(hi - lo, 0.5)
    o = rs.uniform(lo - 2 * span, hi + 2 * span, (4096, 3))
    d = rs.normal(size=(4096, 3))
    axis = np.repeat(np.concatenate([np.eye(3), -np.eye(3)]), 32, axis=0)
    o_axis = rs.uniform(lo - span, hi + span, axis.shape)
    zero = rs.normal(size=(192, 3))
    zero[np.arange(192), np.arange(192) % 3] = 0.0
    o_zero = rs.uniform(lo - span, hi + span, zero.shape)
    face = rs.uniform(lo, hi, (384, 3))
    k = np.arange(384) % 3
    face[np.arange(384), k] = np.where(np.arange(384) % 2, lo[k], hi[k])
    d_face = rs.normal(size=face.shape)
    d_face[::4] = np.eye(3)[k[::4]]     # along the face's normal
    d_face[1::4, :] = d_face[1::4] * (np.eye(3)[k[1::4]] == 0)  # in the face
    o = np.concatenate([o, o_axis, o_zero, face]).astype(np.float32)
    d = np.concatenate([d, axis, zero, d_face]).astype(np.float32)
    d = d / np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-20)
    bound = rs.uniform(0.0, 4.0 * float(span.max()), o.shape[0])
    bound[::9] = 0.0
    return (np.ascontiguousarray(o.T), np.ascontiguousarray(d.T),
            bound.astype(np.float32))


@pytest.mark.parametrize("kind", ["box", "flat", "point", "inverted"])
def test_aabb_cull_rows_equals_jax(kind):
    box = {
        "box": [-1.5, -0.25, -7.0, 0.75, 0.5, -5.5, 0, 0],
        "flat": [-8.0, -1.0, -16.0, 8.0, -1.0, 0.5, 0, 0],      # a floor
        "point": [2.0, 0.25, -3.0, 2.0, 0.25, -3.0, 0, 0],
        "inverted": [3e38, 3e38, 3e38, -3e38, -3e38, -3e38, 0, 0],
    }[kind]
    box = np.asarray(box, np.float32)
    o3, d3, bound = _cull_rays(box, seed=len(kind))
    hit, nonempty = intersect.aabb_cull_rows(
        torch.from_numpy(box)[None, :],
        [torch.from_numpy(o3[k:k + 1]) for k in range(3)],
        [torch.from_numpy(d3[k:k + 1]) for k in range(3)],
        torch.from_numpy(bound)[None, :])
    jhit, jnonempty = _aabb_cull_rows(
        jnp.asarray(box).reshape(1, 1, 8),
        [jnp.asarray(o3[k:k + 1]) for k in range(3)],
        [jnp.asarray(d3[k:k + 1]) for k in range(3)],
        jnp.asarray(bound)[None, :])
    assert hit.shape == (1, o3.shape[1])
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    assert bool(nonempty) == bool(jnonempty) == (kind != "inverted")
    if kind != "inverted":
        assert 0.02 < hit.float().mean().item() < 0.98


# (c) the culled sweep's plain model gives the un-culled bits


SCENES = ["boxfield40", "boxfield40 morton", "cornell"]


@pytest.mark.parametrize("form", ["classic", "plucker"])
@pytest.mark.parametrize("name", SCENES)
def test_culled_any_hit_equals_unculled(name, form):
    scene = _scene(name)
    tripack = intersect.scene_tripack(scene)
    cull = intersect.cull_boxes(tripack)
    pack, pair = ((intersect.plucker_pack(tripack), intersect.PLUCKER)
                  if form == "plucker" else (tripack, intersect.CLASSIC))
    occluders = int((tripack[:, 10] > 0.5).sum())
    for _, _, _, shadow in _wavefronts(name, 3):
        rays = [x.contiguous() for x in (shadow.o3, shadow.d3, shadow.maxd)]
        want = intersect.any_hit_plain(*rays, pack, pair)
        tested = []
        got = intersect.any_hit_plain(*rays, pack, pair, cull, tested)
        assert torch.equal(got, want)
        assert 0.02 < want.float().mean().item() < 0.98
        every = rays[0].shape[1] * occluders
        assert 0 < sum(tested) <= every
        if name != "cornell":   # the room's walls span it: little to cull
            assert sum(tested) < 0.5 * every


@pytest.mark.parametrize("s_samples", [1, 3, 8])
@pytest.mark.parametrize("name", SCENES)
def test_culled_nee_equals_unculled(name, s_samples):
    scene = _scene(name)
    tripack = intersect.scene_tripack(scene)
    lightpack = nee.light_pack(scene)
    cull = intersect.cull_boxes(tripack)
    occluders = int((tripack[:, 10] > 0.5).sum())
    for point3, normal3, u, _ in _wavefronts(name, s_samples):
        mc, occ = nee.nee_mean_cos_plain(point3, normal3, u, tripack,
                                         lightpack, s_samples)
        tested = []
        mc_c, occ_c = nee.nee_mean_cos_plain(point3, normal3, u, tripack,
                                             lightpack, s_samples, cull,
                                             tested)
        assert torch.equal(occ_c, occ)
        torch.testing.assert_close(mc_c, mc, rtol=0, atol=MC_ATOL)
        assert 0.02 < occ.mean().item() < 0.98
        every = occ.numel() * occluders
        assert 0 < sum(tested) <= every
        if name != "cornell":
            assert sum(tested) < 0.5 * every


def test_culled_sweep_skips_parked_lanes_and_empty_groups():
    """A lane with an empty window tests nothing; rows that are not
    occluders are never counted."""
    scene = _scene("boxfield40")
    tripack = intersect.scene_tripack(scene)
    shadow = _wavefronts("boxfield40", 3)[0][3]
    o3, d3 = shadow.o3.contiguous(), shadow.d3.contiguous()
    tested = []
    occ = intersect.any_hit_plain(o3, d3, torch.zeros_like(shadow.maxd),
                                  tripack, cull=intersect.cull_boxes(tripack),
                                  tested=tested)
    assert not occ.any() and sum(tested) == 0


# (d) no accepted hit lies outside its group's box


def _flat(axis, at, lo, hi):
    """An axis-aligned right triangle in the plane ``axis = at``."""
    a, b = [k for k in range(3) if k != axis]
    v = np.full((3, 3), at, np.float32)
    v[0, [a, b]] = lo
    v[1, [a, b]] = (hi[0], lo[1])
    v[2, [a, b]] = (lo[0], hi[1])
    return v


coord = st.floats(-20.0, 20.0, width=32)
unit = st.floats(0.0, 1.0, width=32)
size = st.floats(0.0625, 30.0, width=32)
triangle = st.one_of(
    st.tuples(st.integers(0, 2), coord, coord, coord, size, size).map(
        lambda p: _flat(p[0], p[1], (p[2], p[3]), (p[2] + p[4], p[3] + p[5]))),
    st.lists(coord, min_size=9, max_size=9).map(
        lambda v: np.asarray(v, np.float32).reshape(3, 3)))

# The pair tests' conditioning: |det| / (|e1||e2|) for a unit direction, det
# = e1 . (d x e2) = -(e1 x e2) . d, the sine of the ray's angle to the
# triangle's plane times the sine of the angle between the two edges. u, v
# and t are divided by det, whose rounding error is about 1e-7 |e1||e2|, so
# they carry a relative error of about 1e-7 / conditioning. Down to COND the
# boxes' growth, the slab test's slack and the stretch of its bound by
# ``CULL_REACH`` cover that error and every accepted hit meets its boxes
# (held here); below it the pair tests accept hits at a t
# that is off by more than any fixed slack, which no box can follow: there
# the culled and the un-culled sweep may differ, as they do in the JAX
# package (test_ill_conditioned_hits_are_dropped_by_the_reference_cull_too).
COND = 1e-3


def _conditioning(tri, d):
    """|det| / (|e1||e2|) of triangles [..., 3, 3] against unit directions
    [..., 3]; 0 for a degenerate triangle."""
    e1, e2 = tri[..., 1, :] - tri[..., 0, :], tri[..., 2, :] - tri[..., 0, :]
    scale = e1.norm(dim=-1) * e2.norm(dim=-1)
    det = (torch.linalg.cross(e1, e2) * d).sum(dim=-1).abs()
    return torch.where(scale > 1e-6, det / scale.clamp_min(1e-30), 0.0)


def _point_of(tri, b1, b2, vertex):
    """A point of the triangle by the sqrt trick, or its vertex 0..2."""
    su = float(np.sqrt(b1))
    bary = [1.0 - su, su * (1.0 - b2), su * b2]
    if vertex < 3:
        bary = [float(k == vertex) for k in range(3)]
    return sum(w * tri[k] for k, w in enumerate(bary))


def _own_boxes(rows12):
    """The grown box of every row by itself."""
    return intersect.grow_boxes(
        intersect.block_aabbs(rows12, 1, intersect.OCCLUDER_COL))


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(tri_a=triangle, tri_b=triangle, b1=unit, b2=unit,
       toward_vertex=st.integers(0, 3), a1=unit, a2=unit,
       origin=st.tuples(coord, coord, coord),
       start=st.sampled_from(("anywhere", "on a", "along x", "along y",
                              "along z")),
       slack=st.floats(0.0, 2.0, width=32))
def test_accepted_hit_meets_its_group_box(tri_a, tri_b, b1, b2, toward_vertex,
                                          a1, a2, origin, start, slack):
    """For a ray that ``mt_rows`` or ``plucker_rows`` says hits a triangle
    at t < bound - 1e-4, the slab test of the triangle's own box, of its
    group box and of its tile box holds up to ``bound``, wherever the pair
    test is conditioned (``COND``). The rays are aimed at points, edges and
    vertices of flat (axis-aligned, as a box's faces and a floor are) and
    general triangles, slivers included; they start anywhere, on another
    triangle of the same group (a shadow ray starts on a surface, often a
    face of the box whose group is tested, in its own plane), or run along
    an axis."""
    tri_a, tri_b = (torch.from_numpy(np.asarray(t, np.float32))
                    for t in (tri_a, tri_b))
    target = _point_of(tri_b, b1, b2, toward_vertex)
    o = torch.tensor(origin, dtype=torch.float32)
    if start == "on a":
        o = _point_of(tri_a, a1, a2, 3)
    elif start != "anywhere":
        k = "xyz".index(start[-1])
        o = target.clone()
        o[k] = origin[k]
    d = target - o
    if float(d.norm()) < 1e-3:
        return
    d3 = normalize3(d[:, None].contiguous())
    if float(_conditioning(tri_b, d3[:, 0])) < COND:
        return
    o3 = o[:, None].contiguous()
    rows12 = torch.zeros(2, 12)
    rows12[0, 0:9], rows12[1, 0:9] = tri_a.flatten(), tri_b.flatten()
    rows12[:, 9:11] = 1.0
    cull = intersect.cull_boxes(rows12)
    own = _own_boxes(rows12)[1:2]
    rays = [o3[k:k + 1] for k in range(3)] + [d3[k:k + 1] for k in range(3)]
    for pack, rows in ((rows12, intersect.mt_rows),
                       (intersect.plucker_pack(rows12),
                        intersect.plucker_rows)):
        hit, t = rows(pack[1:2], *rays)
        bound = t[0] + 1e-4 + slack * 1e-3
        if not bool(hit[0, 0]) or not bool(t[0, 0] < bound[0] - 1e-4):
            continue
        meets = intersect.cull_pairs(cull, 1, 2, rays[:3], rays[3:],
                                     bound[None])
        meets_own, nonempty = intersect.aabb_cull_rows(
            own, rays[:3], rays[3:], bound[None] * intersect.CULL_REACH)
        assert bool(meets[0, 0]), (tri_b, o, d3, t, cull)
        assert bool(meets_own[0, 0] & nonempty[0, 0]), (tri_b, o, d3, t, own)


def _aimed_pairs(kind, n, seed):
    """``n`` (triangle, ray) pairs, each ray aimed at a point or a vertex of
    its triangle: (triangles f32[n, 3, 3], origins f32[n, 3], unit
    directions f32[n, 3]). ``kind``: "general" triangles with coordinates in
    [-20, 20]; "flat" ones in an axis plane; "sliver": the third vertex
    within 1e-4..3 of the first edge; "grazing": the origin within
    1e-7..1e-1 rad of the triangle's plane; "far": the origin 100 to 3,000
    away from a triangle of size 1."""
    rs = np.random.default_rng(seed)
    tri = rs.uniform(-20.0, 20.0, (n, 3, 3))
    if kind == "flat":
        axis = rs.integers(0, 3, n)
        tri[np.arange(n), :, axis] = tri[np.arange(n), 0, axis][:, None]
    if kind == "sliver":
        along = rs.random((n, 1))
        tri[:, 2] = (tri[:, 0] + along * (tri[:, 1] - tri[:, 0])
                     + 10.0 ** rs.uniform(-4, 0.5, (n, 1))
                     * rs.normal(size=(n, 3)))
    if kind == "far":
        tri = tri[:, :1] + rs.uniform(-0.5, 0.5, (n, 3, 3))
    su, b2 = np.sqrt(rs.random(n)), rs.random(n)
    bary = np.stack([1.0 - su, su * (1.0 - b2), su * b2], axis=1)
    at_vertex = rs.random(n) < 0.2
    bary[at_vertex] = np.eye(3)[rs.integers(0, 3, int(at_vertex.sum()))]
    target = (bary[:, :, None] * tri).sum(axis=1)
    o = rs.uniform(-20.0, 20.0, (n, 3))
    if kind == "far":
        away = rs.normal(size=(n, 3))
        o = target + away * (10.0 ** rs.uniform(2.0, 3.5, (n, 1))
                             / np.linalg.norm(away, axis=1, keepdims=True))
    if kind == "grazing":
        normal = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        normal /= np.linalg.norm(normal, axis=1, keepdims=True)
        in_plane = o - ((o - tri[:, 0]) * normal).sum(1, keepdims=True) * normal
        lift = (10.0 ** rs.uniform(-7, -1, (n, 1)) * rs.choice([-1, 1], (n, 1))
                * np.linalg.norm(in_plane - target, axis=1, keepdims=True))
        o = in_plane + lift * normal
    tri, o, target = (torch.from_numpy(x.astype(np.float32))
                      for x in (tri, o, target))
    d = target - o
    return tri, o, d / d.norm(dim=1, keepdim=True).clamp_min(1e-20)


def _conditioned_hits(kind, form, own_t):
    """65,536 seeded pairs of ``kind`` in ``form``: (accepted, conditioned,
    meets, the rays, the own boxes, the bound), each flat over the pairs.
    The bound is a shadow segment's end beyond the hit (its t + 1e-4 + up
    to 2e-3), or with ``own_t`` the hit's own t: the bound of a nearest
    sweep whose best is that hit, the tightest at which a row can still
    win."""
    n = 1 << 16
    tri, o, d = _aimed_pairs(kind, n, seed=len(kind))
    rows12 = torch.zeros(n, 12)
    rows12[:, 0:9], rows12[:, 9:11] = tri.reshape(n, 9), 1.0
    pack, rows = ((intersect.plucker_pack(rows12), intersect.plucker_rows)
                  if form == "plucker" else (rows12, intersect.mt_rows))
    rays = [x[:, k].reshape(n, 1, 1) for x in (o, d) for k in range(3)]
    hit, t = rows(pack[:, None, :], *rays)
    if own_t:
        bound = t
        accepted = hit.flatten()
    else:
        slack = torch.from_numpy(np.random.default_rng(1).uniform(
            0.0, 2.0, n).astype(np.float32)).reshape(n, 1, 1)
        bound = t + 1e-4 + slack * 1e-3
        accepted = (hit & (t < bound - 1e-4)).flatten()
    own = _own_boxes(rows12)[:, None, :]
    meets, nonempty = intersect.aabb_cull_rows(
        own, rays[:3], rays[3:], bound * intersect.CULL_REACH)
    meets = (meets & nonempty).flatten()
    conditioned = _conditioning(tri, d) >= COND
    assert int((accepted & conditioned).sum()) > n // 16
    return accepted, conditioned, meets, rays, own, bound


@pytest.mark.parametrize("form", ["classic", "plucker"])
@pytest.mark.parametrize("kind", ["general", "flat", "sliver", "grazing",
                                  "far"])
def test_conditioned_hits_meet_their_boxes(kind, form):
    """The same property over 65,536 seeded pairs a kind, with no triangle
    and no ray left out for its shape: every accepted hit whose pair test
    is conditioned meets its own grown box within the culled sweeps' bound,
    slivers, grazing rays and origins thousands of units away included."""
    n = 1 << 16
    accepted, conditioned, meets, rays, own, bound = _conditioned_hits(
        kind, form, own_t=False)
    assert not bool((accepted & conditioned & ~meets).any())
    if kind == "far" and form == "classic":
        # the stretch is needed: the absolute slack alone loses such hits
        short, _ = intersect.aabb_cull_rows(own, rays[:3], rays[3:], bound)
        assert bool((accepted & conditioned & ~short.flatten()).any())
    if kind in ("sliver", "grazing"):
        # these kinds do reach below COND, where the property ends
        assert int((accepted & ~conditioned).sum()) > n // 16


@pytest.mark.parametrize("form", ["classic", "plucker"])
@pytest.mark.parametrize("kind", ["general", "flat", "sliver", "grazing",
                                  "far"])
def test_conditioned_hits_meet_their_boxes_at_their_own_t(kind, form):
    """The culled nearest sweep's property (``csrc/nearest.cu``): every
    accepted, conditioned hit meets its own grown box with the bound at its
    own t, stretched by ``CULL_REACH``. A lane whose best t is at or above
    a row's t then walks that row's group, so the cull passes over no
    winner."""
    accepted, conditioned, meets, _, _, _ = _conditioned_hits(
        kind, form, own_t=True)
    assert not bool((accepted & conditioned & ~meets).any())


def test_ill_conditioned_hits_are_dropped_by_the_reference_cull_too():
    """Below ``COND`` the cull is no longer exact, in the JAX package as
    here. Rays that graze a tilted triangle from 5 to 25 away, origins
    within 1e-6..1e-3 of its plane: the pair test accepts hits at a t short
    of the true one by more than the slab test's slack, so their segments
    end before the triangle's box. On lanes that both packages' un-culled
    sweeps call occluded, ``_any_hit_kernel_cull`` (one ray block, the
    triangle alone in its triangle block) and the port's culled model both
    answer unoccluded."""
    tri = np.array([[1.3, -2.1, 0.7], [9.1, 1.4, 3.3], [-0.4, 2.9, 8.2]])
    normal = np.cross(tri[1] - tri[0], tri[2] - tri[0])
    normal /= np.linalg.norm(normal)
    rs = np.random.default_rng(11)
    n = 1 << 17
    su, b2 = np.sqrt(rs.random(n)), rs.random(n)
    target = ((1 - su)[:, None] * tri[0] + (su * (1 - b2))[:, None] * tri[1]
              + (su * b2)[:, None] * tri[2])
    away = rs.normal(size=(n, 3))
    away -= (away @ normal)[:, None] * normal
    away *= (rs.uniform(5, 25, n) / np.linalg.norm(away, axis=1))[:, None]
    lift = 10.0 ** rs.uniform(-6, -3, n) * rs.choice([-1, 1], n)
    o = target + away + lift[:, None] * normal
    o3 = torch.from_numpy(np.ascontiguousarray(o.T, np.float32))
    d3 = normalize3(torch.from_numpy(np.ascontiguousarray(
        (target - o).T, np.float32)))
    rows12 = torch.zeros(2 * T_BLK, 12)     # over T_BLK rows: the cull body
    rows12[0, 0:9] = torch.from_numpy(tri.flatten().astype(np.float32))
    rows12[0, 9:11] = 1.0
    rays = [o3[k:k + 1] for k in range(3)] + [d3[k:k + 1] for k in range(3)]
    _, t = intersect.mt_rows(rows12[:1], *rays)
    maxd = (t[0] + 1e-3).clamp_min(0.0)
    want = intersect.any_hit_plain(o3, d3, maxd, rows12[:2])
    got = intersect.any_hit_plain(o3, d3, maxd, rows12[:2],
                                  cull=intersect.cull_boxes(rows12[:2]))
    assert not bool((got & ~want).any())       # a cull only ever drops
    lanes = torch.nonzero(want & ~got).flatten()
    assert len(lanes) > 1000
    cond = _conditioning(torch.from_numpy(tri.astype(np.float32)),
                         d3.T[lanes])
    assert float(cond.max()) < COND

    def jax_bits(pack, pick):
        pad = (-len(pick)) % T_BLK
        pick = torch.cat([pick, pick[:1].expand(pad)])
        return np.array(_any_hit_call(
            jnp.asarray(pack.numpy()), jnp.asarray(o3[:, pick].numpy()),
            jnp.asarray(d3[:, pick].numpy()),
            jnp.asarray(maxd[pick].numpy())[None, :]))[:len(pick) - pad]

    # the lanes the JAX package's un-culled body calls occluded too (its
    # compiler rounds these noise-bound pair tests in its own way)
    both = lanes[jax_bits(rows12[:T_BLK], lanes)]
    assert len(both) >= 16
    block = both[torch.arange(T_BLK) % len(both)]   # one whole ray block
    assert jax_bits(rows12[:T_BLK], block).all()
    assert not jax_bits(rows12, block).any()
    assert bool(want[block].all()) and not bool(got[block].any())


# (e) the JAX package's culled kernels, in interpret mode


def test_culled_model_equals_jax_culled_any_hit():
    """On a pack of more than T_BLK rows ``any_hit_pallas_cm`` runs
    ``_any_hit_kernel_cull``; the port's culled model gives its bits."""
    desc = synthetic.box_field_scene(n_boxes=48, width=24, height=24)
    scene = arrays.pack_scene(desc, pad_to=128, device="cpu")
    ref_scene = jax_arrays.pack_scene(to_jax_desc(desc), pad_to=128)
    assert scene.num_padded_triangles > T_BLK
    rs = np.random.default_rng(5)
    verts = scene.tri_v0.numpy()[scene.tri_valid.numpy()]
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    n = 2048
    o3 = np.ascontiguousarray(rs.uniform(lo, hi, (n, 3)).T, np.float32)
    d3 = normalize3(torch.from_numpy(np.ascontiguousarray(
        rs.normal(size=(n, 3)).T, np.float32))).numpy()
    maxd = rs.uniform(0.0, 25.0, n).astype(np.float32)
    maxd[::7] = 0.0
    tripack = intersect.scene_tripack(scene)
    want = np.asarray(jax_any_hit_pallas_cm(
        jnp.asarray(o3), jnp.asarray(d3), jnp.asarray(maxd), ref_scene))
    occ = scene.tri_occluder.numpy()
    tris = [v.numpy()[occ] for v in (scene.tri_v0, scene.tri_v1,
                                     scene.tri_v2)]
    got = intersect.any_hit_plain(
        torch.from_numpy(o3), torch.from_numpy(d3), torch.from_numpy(maxd),
        tripack, cull=intersect.cull_boxes(tripack)).numpy()
    assert 0.05 < got.mean() < 0.95
    # XLA:CPU may fuse a product into an add: a bit may differ only where
    # the ray grazes an edge or the window's end
    for r in np.nonzero(got != want)[0]:
        margin = occlusion_margin_f64(*tris, o3[:, r], d3[:, r], maxd[r])
        assert abs(margin) < GRAZING_MARGIN, (r, margin)
    assert (got != want).mean() < 1e-3


def test_culled_model_equals_jax_culled_nee():
    """The same for the fused NEE: ``_nee_body`` under ``cull=True``."""
    name, s_samples = "boxfield300", 3
    scene = _scene(name)
    ref_scene = jax_arrays.pack_scene(to_jax_desc(synthetic.box_field_scene(
        n_boxes=300, width=16, height=16)), pad_to=128)
    assert scene.num_padded_triangles > T_BLK
    tripack = intersect.scene_tripack(scene)
    point3, normal3, u, _ = _wavefronts(name, s_samples)[0]
    jpack = _pad_dim(pack_triangles(
        ref_scene.tri_v0, ref_scene.tri_v1, ref_scene.tri_v2,
        ref_scene.tri_valid, ref_scene.tri_occluder), T_BLK, axis=0)
    jmc, jocc = _nee_fwd_impl(
        jnp.asarray(point3.numpy()), jnp.asarray(normal3.numpy()),
        ref_scene.light_v0, ref_scene.light_v1, ref_scene.light_v2,
        ref_scene.light_area, jnp.asarray(u.numpy()), jpack,
        _light_pack(ref_scene), s_samples)
    mc, occ = nee.nee_mean_cos_plain(
        point3, normal3, u, tripack, nee.light_pack(scene), s_samples,
        intersect.cull_boxes(tripack))
    same = occ.numpy() == np.asarray(jocc)
    assert same.mean() > 1.0 - 1e-3
    lanes = same.all(axis=0)
    np.testing.assert_allclose(mc.numpy()[0][lanes], np.asarray(jmc)[0][lanes],
                               rtol=0, atol=1e-5)
