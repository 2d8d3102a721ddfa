"""The box cull of the dense nearest sweep (K1 and K3's dense nearest): its
boxes against the JAX package's ``_block_aabbs``, the plain model of the
culled sweep (``nearest_t_idx_plain`` with ``cull=``) against the un-culled
plain sweep, and against the JAX package's culled Pallas kernels
``_nearest_kernel_cull`` and ``_nearest_kernel_plucker_cull`` in interpret
mode.

The cull's bound is each lane's running best t, so it changes no winner
wherever the pair test is conditioned (|det| >= 1e-3 |e1||e2|; see
``csrc/nearest.cu``). Below that an accepted t is rounding noise, and a
culled sweep can pass over such a "hit" that the un-culled sweep takes as
its winner, here as in ``_nearest_kernel_cull``: the scenes below are
axis-aligned boxes, a floor and a light, whose pair tests are conditioned
for every ray that is not parallel to a face.

Tolerances: boxes equal bit for bit; the culled model against the un-culled
plain sweep: winners and t equal on every lane; against the JAX kernels:
those of ``tests/test_torch_intersect.py`` (classic: winners equal but on
lanes within 1e-5 of an edge by the float64 barycentric margin, t within
rtol = atol = 1e-6) and ``tests/test_torch_plucker.py`` (Plücker: XLA's
``dot_general`` sums a side in its own order, so winners equal but on lanes
within 1e-4 of an edge, t within rtol 1e-5). The rays include rays aimed at
vertices, so the share of differing lanes is capped at 10% only, as
``tests/test_torch_intersect.py`` caps it: the margin is the gate."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.kernels import intersect_pallas as ip
from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu_torch.kernels import intersect
from pathtracerpython_tpu_torch.ops import rng
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.ops.geometry import normalize3
from pathtracerpython_tpu_torch.render import integrator
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.scene import arrays, synthetic
from torch_parity import (
    GRAZING_MARGIN,
    T_ATOL,
    T_RTOL,
    bary_margin_f64,
    to_jax_desc,
)

FORM_MARGIN = 1e-4    # Plücker against JAX: margin of a differing lane
T_RTOL_FORM = 1e-5    # t on the other lanes


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread takes the same time alone and
    does not fight the other test workers for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _scene(name):
    if name == "cornell":      # one tile of 64 rows, a 2-triangle light
        return arrays.pack_scene(synthetic.cornell_box_scene(32, 32),
                                 pad_to=32, device="cpu")
    field = synthetic.box_field_scene(n_boxes=300, width=16, height=16)
    if name == "boxfield300 morton":
        return arrays.pack_scene(field, tri_order="morton", device="cpu")
    assert name == "boxfield300"   # 3,604 triangles in 15 tiles
    return arrays.pack_scene(field, pad_to=128, device="cpu")


@functools.lru_cache(maxsize=None)
def _wavefronts(name):
    """(o3, d3 unit) of the scene's first and second bounce wavefronts, as
    the render forms them."""
    scene = _scene(name)
    cfg = RenderConfig(n_samples=1, n_bounces=2, batch_samples=True)
    w, h = scene.meta.width, scene.meta.height
    origins, dirs = make_primary_rays(scene.eye, scene.ortho, w, h)
    state = integrator.init_rays(origins.T.contiguous(), dirs.T.contiguous(),
                                 torch.arange(w * h))
    k0, k1 = rng.key_from_seed(0)
    out = []
    for b in range(2):
        _, o3, d3 = integrator.sort_and_park(state, None)
        out.append((o3.contiguous(), normalize3(d3).contiguous()))
        state = integrator.bounce_step(state, b, scene, cfg, k0, k1, None)
    return out


def _light_and_miss_rays(scene, n=256, seed=3):
    """Rays from points inside the scene's bounds aimed at random points of
    the light's triangles, and rays in random directions, of which some
    leave the scene: (o3, d3 unit)."""
    rs = np.random.default_rng(seed)
    valid = scene.tri_valid.numpy()
    verts = scene.tri_v0.numpy()[valid]
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    light = np.nonzero(scene.tri_is_light.numpy())[0]
    tri = [v.numpy()[light] for v in (scene.tri_v0, scene.tri_v1,
                                      scene.tri_v2)]
    pick = rs.integers(0, len(light), n)
    su, b2 = np.sqrt(rs.random(n)), rs.random(n)
    target = ((1 - su)[:, None] * tri[0][pick]
              + (su * (1 - b2))[:, None] * tri[1][pick]
              + (su * b2)[:, None] * tri[2][pick])
    o = rs.uniform(lo, hi, (2 * n, 3))
    d = np.concatenate([target - o[:n], rs.normal(size=(n, 3))])
    o3 = torch.from_numpy(np.ascontiguousarray(o.T, np.float32))
    d3 = torch.from_numpy(np.ascontiguousarray(d.T, np.float32))
    return o3, normalize3(d3).contiguous()


def _packs(scene, form):
    tripack = intersect.scene_tripack(scene)
    if form == "plucker":
        return tripack, intersect.plucker_pack(tripack), intersect.PLUCKER
    return tripack, tripack, intersect.CLASSIC


# (a) the boxes


@pytest.mark.parametrize("name", ["cornell", "boxfield300"])
def test_nearest_boxes_equal_jax_block_aabbs_grown(name):
    """Tile and group boxes are ``_block_aabbs`` of the pack (valid rows,
    no occluder mask), grown; the light's rows lie inside their group's
    box and their tile's, which the shadow sweep's boxes leave out."""
    tripack = intersect.scene_tripack(_scene(name))
    cull = intersect.nearest_cull_boxes(tripack)
    for boxes, block in ((cull.tile, intersect.TILE_ROWS),
                         (cull.group, intersect.CULL_GROUP)):
        padded = ip._pad_dim(jnp.asarray(tripack.numpy()), block, axis=0)
        want = torch.from_numpy(np.array(ip._block_aabbs(padded,
                                                         block))[:, 0, :])
        assert torch.equal(boxes, intersect.grow_boxes(want))
    light = torch.nonzero((tripack[:, 9] > 0.5)
                          & (tripack[:, 10] < 0.5)).flatten()
    assert len(light) == 2
    own = intersect.block_aabbs(tripack[light], 1)
    shadow = intersect.cull_boxes(tripack)
    for boxes, block in ((cull.group, intersect.CULL_GROUP),
                         (cull.tile, intersect.TILE_ROWS)):
        outer = boxes[light // block]
        assert bool((outer[:, 0:3] < own[:, 0:3]).all())
        assert bool((outer[:, 3:6] > own[:, 3:6]).all())
    held = shadow.group[light // intersect.CULL_GROUP]
    inside = (held[:, 0:3] <= own[:, 0:3]).all(1) & (
        held[:, 3:6] >= own[:, 3:6]).all(1)
    assert not bool(inside.any())


def test_nearest_boxes_are_cached_beside_the_shadow_boxes():
    """A render derives each set once per scene; the nearest sweep's boxes
    do not replace the shadow sweep's."""
    scene = _scene("cornell")
    near = intersect.scene_nearest_cull_boxes(scene)
    shadow = intersect.scene_cull_boxes(scene)
    assert intersect.scene_nearest_cull_boxes(scene) is near
    assert intersect.scene_cull_boxes(scene) is shadow
    assert not torch.equal(near.group, shadow.group)
    assert near.tile.shape == (1, 8) and near.group.shape == (32, 8)


# (b) the culled model gives the un-culled winners


@pytest.mark.parametrize("form", ["classic", "plucker"])
@pytest.mark.parametrize("name", ["cornell", "boxfield300",
                                  "boxfield300 morton"])
def test_culled_nearest_equals_unculled(name, form):
    """On the render's first and second bounce wavefronts and on rays aimed
    at the light or away: winners and t of every lane equal, lanes whose
    nearest hit is the light and lanes that miss among them, while the cull
    tests few of the pairs."""
    scene = _scene(name)
    tripack, pack, pair = _packs(scene, form)
    cull = intersect.nearest_cull_boxes(tripack)
    # the wavefronts and the aimed rays side by side: one sweep
    o3, d3 = (torch.cat(x, dim=1).contiguous() for x in zip(
        *_wavefronts(name), _light_and_miss_rays(scene)))
    want_t, want_idx = intersect.nearest_t_idx_plain(o3, d3, pack, pair)
    tested = []
    t, idx = intersect.nearest_t_idx_plain(o3, d3, pack, pair, cull, tested)
    assert torch.equal(idx, want_idx) and torch.equal(t, want_t)
    assert int(scene.tri_is_light[idx[idx >= 0]].sum()) > 32
    assert int((idx < 0).sum()) > 32
    every = o3.shape[1] * int((tripack[:, 9] > 0.5).sum())
    assert 0 < tested[0] < every
    if name != "cornell":   # one tile of room walls: little to cull
        assert tested[0] < 0.02 * every


def test_duplicate_triangle_in_a_later_tile_loses_under_the_cull():
    """The culled twin of ``test_duplicate_triangle_smallest_index_wins``:
    the floor again after the boxes, two tiles later. Rays aimed at the
    floor hit both copies at the same t, and the copy of the smaller index
    wins, in the culled model and in ``_nearest_kernel_cull``."""
    desc = synthetic.box_field_scene(n_boxes=48, width=8, height=8)
    desc.objects = desc.objects + [desc.objects[0]]
    scene = arrays.pack_scene(desc, pad_to=128, device="cpu")
    ref = jax_arrays.pack_scene(to_jax_desc(desc), pad_to=128)
    tripack = intersect.scene_tripack(scene)
    assert tripack.shape[0] > ip.T_BLK      # the JAX kernel's cull body
    floor = tripack[0:2]
    copies = torch.nonzero((tripack[:, 0:9][:, None, :] == floor[None, :, 0:9])
                           .all(dim=2).any(dim=1)).flatten().tolist()
    assert copies[:2] == [0, 1] and min(copies[2:]) >= 2 * intersect.TILE_ROWS
    rs = np.random.default_rng(7)
    target = np.stack([rs.uniform(-8, 8, 512), np.full(512, -1.0),
                       rs.uniform(-16, 0.5, 512)], axis=1)
    eye = scene.eye.numpy()
    o3 = np.ascontiguousarray(np.broadcast_to(eye, target.shape).T,
                              np.float32)
    d3 = normalize3(torch.from_numpy(np.ascontiguousarray(
        (target - eye).T, np.float32))).numpy()
    t, idx = intersect.nearest_t_idx_plain(
        torch.from_numpy(o3), torch.from_numpy(d3), tripack,
        cull=intersect.nearest_cull_boxes(tripack))
    jt, jidx = map(np.asarray, ip.nearest_t_idx_cm(jnp.asarray(o3),
                                                   jnp.asarray(d3), ref))
    on_floor = np.isin(idx.numpy(), [0, 1])
    assert on_floor.sum() > 64
    assert not np.isin(idx.numpy(), copies[2:]).any()
    np.testing.assert_array_equal(jidx[on_floor], idx.numpy()[on_floor])


# (c) the JAX package's culled kernels, in interpret mode


def _jax_rays(scene, seed=0):
    """Primary rays, random rays inside the scene, rays aimed at triangle
    vertices (ties and edge hits) and rays that miss, as
    ``tests/test_torch_intersect.py`` draws them: (o3, d3 unit) numpy."""
    rs = np.random.default_rng(seed)
    o, d = make_primary_rays(scene.eye, scene.ortho, scene.meta.width,
                             scene.meta.height)
    valid = scene.tri_valid.numpy()
    verts = np.concatenate([scene.tri_v0.numpy()[valid],
                            scene.tri_v1.numpy()[valid]])
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    eye = scene.eye.numpy()
    targets = verts[:256]
    away = np.tile([[0.0, 0.0, 1.0]], (32, 1))
    origins = [o.numpy(), rs.uniform(lo, hi, (1024, 3)),
               np.broadcast_to(eye, targets.shape),
               np.broadcast_to(eye, away.shape)]
    dirs = [d.numpy(), rs.normal(size=(1024, 3)), targets - eye, away]
    o3 = np.ascontiguousarray(np.concatenate(origins).T, np.float32)
    d3 = np.ascontiguousarray(np.concatenate(dirs).T, np.float32)
    return o3, normalize3(torch.from_numpy(d3)).numpy()


@pytest.mark.parametrize("form", ["classic", "plucker"])
def test_culled_model_equals_jax_culled_nearest(form, monkeypatch):
    """On a pack of more than ``T_BLK`` rows ``nearest_t_idx_cm`` runs
    ``_nearest_kernel_cull`` (``_nearest_kernel_plucker_cull`` under
    ``MT_IMPL = "plucker"``); the port's culled model gives its winners."""
    desc = synthetic.box_field_scene(n_boxes=48, width=24, height=24)
    scene = arrays.pack_scene(desc, pad_to=128, device="cpu")
    ref = jax_arrays.pack_scene(to_jax_desc(desc), pad_to=128)
    assert scene.num_padded_triangles > ip.T_BLK
    monkeypatch.setattr(ip, "MT_IMPL", form)
    o3, d3 = _jax_rays(scene)
    tripack, pack, pair = _packs(scene, form)
    rays = torch.from_numpy(o3), torch.from_numpy(d3)
    t, idx = intersect.nearest_t_idx_plain(
        *rays, pack, pair, intersect.nearest_cull_boxes(tripack))
    want_t, want_idx = intersect.nearest_t_idx_plain(*rays, pack, pair)
    assert torch.equal(idx, want_idx) and torch.equal(t, want_t)
    t, idx = t.numpy(), idx.numpy()
    jt, jidx = map(np.asarray, ip.nearest_t_idx_cm(jnp.asarray(o3),
                                                   jnp.asarray(d3), ref))
    assert (idx < 0).any() and (idx >= 0).mean() > 0.25
    plucker = form == "plucker"
    margin = FORM_MARGIN if plucker else GRAZING_MARGIN
    same = idx == jidx
    bad = np.nonzero(~same)[0]
    assert len(bad) <= 0.1 * len(idx)   # the vertex-aimed rays graze
    tri = [scene.tri_v0.numpy(), scene.tri_v1.numpy(), scene.tri_v2.numpy()]
    for r in bad:
        margins = [abs(bary_margin_f64(tri[0][i], tri[1][i], tri[2][i],
                                       o3[:, r], d3[:, r]))
                   for i in (idx[r], jidx[r]) if i >= 0]
        assert margins and min(margins) < margin, (r, margins)
    np.testing.assert_allclose(t[same], jt[same],
                               rtol=T_RTOL_FORM if plucker else T_RTOL,
                               atol=T_ATOL)
