"""K1 and K4, the dense nearest-hit and any-hit sweeps: the port's plain
versions against the JAX package's Pallas kernels, run in interpret mode on
the CPU as tests/test_pallas.py runs them, plus the wrappers' input
checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.kernels.intersect_pallas import (
    any_hit_pallas_cm as jax_any_hit_pallas_cm,
)
from pathtracerpython_tpu.kernels.intersect_pallas import (
    nearest_t_idx_cm as jax_nearest_t_idx_cm,
)
from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu_torch.kernels import intersect
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.ops.geometry import (
    nearest_hit_cm,
    normalize3,
    safe_normalize,
)
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


def _scenes():
    # box_field(48): 580 triangles padded to 640 > 512, so the JAX kernel
    # runs its AABB-culled path over two triangle blocks
    return {
        "cornell": (synthetic.cornell_box_scene(24, 24), 32),
        "boxfield48": (synthetic.box_field_scene(n_boxes=48, width=24,
                                                 height=24), 128),
    }


def _rays(scene, seed=0):
    """Primary rays, random rays inside the scene, rays aimed exactly at
    triangle vertices (ties and edge hits) and rays that miss."""
    rs = np.random.default_rng(seed)
    w, h = scene.meta.width, scene.meta.height
    o, d = make_primary_rays(scene.eye, scene.ortho, w, h)
    origins, dirs = [o.numpy()], [d.numpy()]
    valid = scene.tri_valid.numpy()
    verts = np.concatenate([scene.tri_v0.numpy()[valid],
                            scene.tri_v1.numpy()[valid]])
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    n_rand = 1024
    origins.append(rs.uniform(lo, hi, (n_rand, 3)).astype(np.float32))
    dirs.append(rs.normal(size=(n_rand, 3)).astype(np.float32))
    eye = scene.eye.numpy()
    targets = verts[:256]
    origins.append(np.broadcast_to(eye, targets.shape))
    dirs.append(targets - eye)
    away = np.tile([[0.0, 0.0, 1.0]], (32, 1)).astype(np.float32)
    origins.append(np.broadcast_to(eye, away.shape))
    dirs.append(away)
    o3 = np.ascontiguousarray(np.concatenate(origins).T, np.float32)
    d3 = np.ascontiguousarray(np.concatenate(dirs).T, np.float32)
    d3u = normalize3(torch.from_numpy(d3)).numpy()
    return o3, d3u


@pytest.mark.parametrize("name", ["cornell", "boxfield48"])
def test_plain_nearest_matches_jax_kernel(name):
    desc, pad_to = _scenes()[name]
    scene = arrays.pack_scene(desc, pad_to=pad_to, device="cpu")
    ref_scene = jax_arrays.pack_scene(to_jax_desc(desc), pad_to=pad_to)
    o3, d3u = _rays(scene)
    t, idx = intersect.nearest_t_idx_cm(torch.from_numpy(o3),
                                        torch.from_numpy(d3u), scene)
    t, idx = t.numpy(), idx.numpy()
    jt, jidx = map(np.asarray, jax_nearest_t_idx_cm(
        jnp.asarray(o3), jnp.asarray(d3u), ref_scene))

    assert idx.dtype == np.int32 and t.dtype == np.float32
    # miss convention: idx -1 and t 0
    for tt, ii in ((t, idx), (jt, jidx)):
        assert (tt[ii < 0] == 0.0).all()
    assert (idx < 0).any() and (idx >= 0).mean() > 0.25

    same = idx == jidx
    bad = np.nonzero(~same)[0]
    # only the vertex-aimed rays graze; the cap is a sanity bound
    assert len(bad) <= 0.1 * len(idx), f"{len(bad)} winner mismatches"
    tri = [scene.tri_v0.numpy(), scene.tri_v1.numpy(), scene.tri_v2.numpy()]
    for r in bad:
        margins = [abs(bary_margin_f64(tri[0][i], tri[1][i], tri[2][i],
                                       o3[:, r], d3u[:, r]))
                   for i in (idx[r], jidx[r]) if i >= 0]
        assert margins and min(margins) < GRAZING_MARGIN, (r, margins)
    np.testing.assert_allclose(t[same], jt[same], rtol=T_RTOL, atol=T_ATOL)


def test_duplicate_triangle_smallest_index_wins():
    """Two identical quads: rays through their interiors hit both at the
    same t, and the lower buffer index must win, as in the JAX kernel."""
    desc = synthetic.cornell_box_scene(8, 8)
    back = desc.objects[4]
    desc.objects = [back, back] + desc.objects[5:]
    scene = arrays.pack_scene(desc, pad_to=32, device="cpu")
    ref_scene = jax_arrays.pack_scene(to_jax_desc(desc), pad_to=32)
    tri = scene.tri_v0[:2] + scene.tri_v1[:2] + scene.tri_v2[:2]
    centers = (tri / 3.0).numpy()
    eye = scene.eye.numpy()
    o3 = np.ascontiguousarray(np.broadcast_to(eye, centers.shape).T)
    d3u = normalize3(torch.from_numpy(
        np.ascontiguousarray((centers - eye).T))).numpy()
    _, idx = intersect.nearest_t_idx_cm(torch.from_numpy(o3),
                                        torch.from_numpy(d3u), scene)
    _, jidx = jax_nearest_t_idx_cm(jnp.asarray(o3), jnp.asarray(d3u),
                                   ref_scene)
    np.testing.assert_array_equal(idx.numpy(), [0, 1])
    np.testing.assert_array_equal(np.asarray(jidx), [0, 1])


def test_nearest_hit_record():
    scene = arrays.pack_scene(synthetic.cornell_box_scene(8, 8), pad_to=32,
                              device="cpu")
    o3, d3u = _rays(scene)
    o3, d3 = torch.from_numpy(o3), torch.from_numpy(d3u) * 3.0
    hit = nearest_hit_cm(o3, d3, scene)
    d3u = normalize3(d3)
    t, idx = intersect.nearest_t_idx_cm(o3, d3u, scene)
    assert torch.equal(hit.t, t)
    assert torch.equal(hit.hit, idx >= 0)
    assert torch.equal(hit.tri_idx, idx.clamp_min(0))
    rows = hit.tri_idx.long()
    assert torch.equal(hit.normal3, scene.tri_normal[rows].T)
    assert torch.equal(hit.material, scene.tri_material[rows])
    assert torch.equal(hit.is_light, scene.tri_is_light[rows] & hit.hit)
    assert torch.equal(hit.point3, o3 + d3u * t)


def test_normalize_helpers():
    v = torch.tensor([[3.0, 0.0], [4.0, 0.0], [0.0, 0.0]])
    torch.testing.assert_close(normalize3(v), torch.tensor(
        [[0.6, 0.0], [0.8, 0.0], [0.0, 0.0]]))
    torch.testing.assert_close(safe_normalize(v.T), normalize3(v).T)


def _inputs(n=8):
    o3 = torch.zeros(3, n)
    d3 = torch.zeros(3, n)
    d3[2] = -1.0
    return o3, d3


@pytest.mark.parametrize("fault", [
    "requires_grad", "dtype", "shape", "mismatch", "noncontiguous", "device",
])
def test_wrapper_refuses_bad_inputs(fault):
    scene = arrays.pack_scene(synthetic.cornell_box_scene(8, 8), pad_to=32,
                              device="cpu")
    o3, d3 = _inputs()
    expected = ValueError
    if fault == "requires_grad":
        # no fault since the sweeps carry gradients: t is differentiable,
        # the winner is not, and the values are the no-grad call's
        want = intersect.nearest_t_idx_cm(o3, d3, scene)
        o3.requires_grad_(True)
        t, idx = intersect.nearest_t_idx_cm(o3, d3, scene)
        assert t.requires_grad and not idx.requires_grad
        assert torch.equal(t.detach(), want[0]) and torch.equal(idx, want[1])
        return
    if fault == "dtype":
        o3 = o3.double()
        expected = TypeError
    elif fault == "shape":
        o3, d3 = o3[:2], d3[:2]
    elif fault == "mismatch":
        d3 = d3[:, :4]
    elif fault == "noncontiguous":
        o3 = torch.zeros(8, 3).T
    elif fault == "device":
        o3, d3 = o3.to("meta"), d3.to("meta")
    with pytest.raises(expected):
        intersect.nearest_t_idx_cm(o3, d3, scene)


@pytest.mark.parametrize("name", ["cornell", "boxfield48"])
def test_plain_any_hit_matches_jax_kernel(name):
    desc, pad_to = _scenes()[name]
    scene = arrays.pack_scene(desc, pad_to=pad_to, device="cpu")
    ref_scene = jax_arrays.pack_scene(to_jax_desc(desc), pad_to=pad_to)
    o3, d3u = _rays(scene, seed=2)
    maxd = np.random.default_rng(3).uniform(0.0, 25.0, o3.shape[1]).astype(
        np.float32)
    maxd[::7] = 0.0  # parked-style empty windows
    got = intersect.any_hit_cm(torch.from_numpy(o3), torch.from_numpy(d3u),
                               torch.from_numpy(maxd), scene).numpy()
    want = np.asarray(jax_any_hit_pallas_cm(
        jnp.asarray(o3), jnp.asarray(d3u), jnp.asarray(maxd), ref_scene))
    assert got.dtype == np.bool_ and 0.05 < got.mean() < 0.95
    assert not got[::7].any()
    bad = np.nonzero(got != want)[0]
    assert len(bad) <= 0.1 * len(got), f"{len(bad)} occlusion mismatches"
    occ = scene.tri_occluder.numpy()
    tris = [v.numpy()[occ] for v in (scene.tri_v0, scene.tri_v1,
                                     scene.tri_v2)]
    for r in bad:
        margin = occlusion_margin_f64(*tris, o3[:, r], d3u[:, r], maxd[r])
        assert abs(margin) < GRAZING_MARGIN, (r, margin)


@pytest.mark.parametrize("fault", ["requires_grad", "maxd_shape", "dtype"])
def test_any_hit_wrapper_refuses_bad_inputs(fault):
    scene = arrays.pack_scene(synthetic.cornell_box_scene(8, 8), pad_to=32,
                              device="cpu")
    o3, d3 = _inputs()
    maxd = torch.ones(8)
    expected = ValueError
    if fault == "requires_grad":
        # no fault: occlusion is detached by design, as in the JAX package
        want = intersect.any_hit_cm(o3, d3, maxd, scene)
        maxd.requires_grad_(True)
        got = intersect.any_hit_cm(o3, d3, maxd, scene)
        assert not got.requires_grad and torch.equal(got, want)
        return
    if fault == "maxd_shape":
        maxd = maxd[:5]
    else:
        maxd = maxd.double()
        expected = TypeError
    with pytest.raises(expected):
        intersect.any_hit_cm(o3, d3, maxd, scene)
