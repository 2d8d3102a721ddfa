"""K2, the fused fast-mode NEE: the port's plain version against the JAX
package's Pallas kernel in interpret mode, for 1 and 3 light samples and
lights of 2 and 8 triangles, plus the wrapper's input checks."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.kernels.intersect_pallas import (
    T_BLK,
    _pad_dim,
    pack_triangles,
)
from pathtracerpython_tpu.kernels.nee_pallas import (
    _light_pack,
    _nee_fwd_impl,
    nee_mean_cos_fused as jax_nee_mean_cos_fused,
)
from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu_torch.kernels import nee
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.ops.geometry import nearest_hit_cm, normalize3
from pathtracerpython_tpu_torch.render.integrator import arrival_side_normal
from pathtracerpython_tpu_torch.scene import arrays, synthetic
from torch_parity import GRAZING_MARGIN, occlusion_margin_f64, to_jax_desc

# mean cosine of lanes whose occlusion bits agree: float32 sums of three
# terms of size <= 1, where the last bits of rsqrt may differ
MC_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: with one intra-op thread these tests take
    the same time alone and do not fight the other test workers for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _desc(n_light_tris):
    desc = synthetic.cornell_box_scene(24, 24)
    if n_light_tris == 8:
        desc = dataclasses.replace(desc, light_mesh=synthetic.grid_light(
            2, 2, 3.0, -0.45, 0.45, -24.3, -22.5))
    assert desc.light_mesh.num_triangles == n_light_tris
    return desc


def _shading_points(scene, seed=0):
    """Primary hits and hits of random rays from inside the room, with
    arrival-side normals, as contiguous [3, N] tensors."""
    rs = np.random.default_rng(seed)
    o, d = make_primary_rays(scene.eye, scene.ortho, scene.meta.width,
                             scene.meta.height)
    n_rand = 512
    o_rand = rs.uniform([-3.5, -3.5, -30.0], [3.5, 3.5, -2.0], (n_rand, 3))
    d_rand = rs.normal(size=(n_rand, 3))
    o3 = torch.cat([o.T, torch.from_numpy(o_rand.T.astype(np.float32))], 1)
    d3 = torch.cat([d.T, torch.from_numpy(d_rand.T.astype(np.float32))], 1)
    o3, d3 = o3.contiguous(), d3.contiguous()
    hit = nearest_hit_cm(o3, d3, scene)
    normal3 = arrival_side_normal(hit.normal3, normalize3(d3))
    return hit.point3.contiguous(), normal3.contiguous()


def _jax_nee(ref_scene, point3, normal3, u, s_samples):
    tripack = pack_triangles(ref_scene.tri_v0, ref_scene.tri_v1,
                             ref_scene.tri_v2, ref_scene.tri_valid,
                             ref_scene.tri_occluder)
    tripack = _pad_dim(tripack, min(T_BLK, max(tripack.shape[0], 1)), axis=0)
    mc, occ = _nee_fwd_impl(
        jnp.asarray(point3), jnp.asarray(normal3), ref_scene.light_v0,
        ref_scene.light_v1, ref_scene.light_v2, ref_scene.light_area,
        jnp.asarray(u), tripack, _light_pack(ref_scene), s_samples,
    )
    return np.asarray(mc), np.asarray(occ)


def _shadow_ray_f64(scene, p, u5):
    """The sample's shadow ray (direction, distance) in float64, from the
    same pick and barycentrics as the kernel."""
    area = scene.light_area.numpy().astype(np.float64)
    cum = np.cumsum(area)
    x = np.float64(np.float32(u5[0]) * np.float32(cum[-1]))
    pick = int(np.sum(x >= cum[:-1]))
    v0, v1, v2 = (getattr(scene, f"light_v{k}").numpy()[pick].astype(np.float64)
                  for k in range(3))
    su = np.sqrt(np.float64(u5[1]))
    lp = (1 - su) * v0 + su * (1 - u5[2]) * v1 + su * u5[2] * v2
    vec = lp - p
    dist = np.linalg.norm(vec)
    return vec / dist, dist


@pytest.mark.parametrize("n_light_tris", [2, 8])
@pytest.mark.parametrize("s_samples", [1, 3])
def test_plain_nee_matches_jax_kernel(s_samples, n_light_tris):
    desc = _desc(n_light_tris)
    scene = arrays.pack_scene(desc, pad_to=32, device="cpu")
    ref_scene = jax_arrays.pack_scene(to_jax_desc(desc), pad_to=32)
    point3, normal3 = _shading_points(scene)
    n = point3.shape[1]
    u = np.random.default_rng(s_samples).uniform(
        size=(5 * s_samples, n)).astype(np.float32)

    mc, occ = nee.nee_mean_cos_fused(point3, normal3, torch.from_numpy(u),
                                     scene, s_samples)
    mc, occ = mc.numpy(), occ.numpy()
    jmc, jocc = _jax_nee(ref_scene, point3.numpy(), normal3.numpy(), u,
                         s_samples)
    np.testing.assert_array_equal(
        np.asarray(jax_nee_mean_cos_fused(
            jnp.asarray(point3.numpy()), jnp.asarray(normal3.numpy()),
            jnp.asarray(u), ref_scene, s_samples)), jmc)

    assert mc.shape == (1, n) and occ.shape == (s_samples, n)
    assert set(np.unique(occ)) <= {0.0, 1.0}
    assert 0.0 < occ.mean() < 1.0  # both verdicts occur
    assert (mc >= 0).all() and (mc <= 1).all()

    occluders = scene.tri_occluder.numpy()
    tris = [getattr(scene, f"tri_v{k}").numpy()[occluders] for k in range(3)]
    p_np = point3.numpy()
    for s, lane in zip(*np.nonzero(occ != jocc)):
        d, dist = _shadow_ray_f64(scene, p_np[:, lane].astype(np.float64),
                                  u[5 * s:5 * s + 3, lane])
        margin = occlusion_margin_f64(*tris, p_np[:, lane], d, dist)
        assert abs(margin) < GRAZING_MARGIN, (s, lane, margin)
    assert (occ != jocc).mean() <= 0.01
    agree = (occ == jocc).all(axis=0)
    np.testing.assert_allclose(mc[0][agree], jmc[0][agree], rtol=0,
                               atol=MC_ATOL)


def test_light_pack_holds_cumulative_area():
    scene = arrays.pack_scene(_desc(8), pad_to=32, device="cpu")
    pack = nee.light_pack(scene)
    assert tuple(pack.shape) == (8, 12)
    torch.testing.assert_close(pack[:, 9], torch.cumsum(scene.light_area, 0))
    assert torch.equal(pack[:, 0:3], scene.light_v0)
    assert torch.equal(pack[:, 6:9], scene.light_v2)


@pytest.mark.parametrize("fault", [
    "samples_low", "samples_high", "requires_grad", "u_shape", "dtype",
    "big_light",
])
def test_wrapper_refuses_bad_inputs(fault):
    desc = _desc(2)
    s_samples = 3
    if fault == "big_light":
        desc = dataclasses.replace(desc, light_mesh=synthetic.grid_light(
            6, 6, 3.0, -0.45, 0.45, -24.3, -22.5))  # 72 triangles
    scene = arrays.pack_scene(desc, pad_to=32, device="cpu")
    point3 = torch.zeros(3, 8)
    normal3 = torch.zeros(3, 8)
    normal3[1] = 1.0
    u = torch.full((5 * s_samples, 8), 0.5)
    expected = ValueError
    if fault == "samples_low":
        s_samples = 0
    elif fault == "samples_high":
        s_samples = nee.MAX_LIGHT_SAMPLES + 1
    elif fault == "requires_grad":
        # no fault since K2 carries its gradient (NeeMeanCos): the mean
        # cosine is differentiable, the occlusion is not, and the values
        # are the no-grad call's
        want = nee.nee_mean_cos_fused(point3, normal3, u, scene, s_samples)
        normal3.requires_grad_(True)
        mc, occ = nee.nee_mean_cos_fused(point3, normal3, u, scene,
                                         s_samples)
        assert mc.requires_grad and not occ.requires_grad
        assert torch.equal(mc.detach(), want[0]) and torch.equal(occ, want[1])
        return
    elif fault == "u_shape":
        u = u[:-1]
    elif fault == "dtype":
        point3 = point3.double()
        expected = TypeError
    with pytest.raises(expected):
        nee.nee_mean_cos_fused(point3, normal3, u, scene, s_samples)
