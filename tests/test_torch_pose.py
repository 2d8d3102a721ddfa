"""The pose and camera apps (``apps/fit_pose.py``, ``apps/fit_camera.py``)
on the CPU: the object lookup on the Cornell stand-in, the anneal and the
resolution pyramid against the JAX app's formulas (inline in its ``run``),
step 0 of the planar object fit against the JAX package's
``jax.value_and_grad`` of the same loss, short light, object and camera
runs whose losses fall, and the blocker fit of
``tests/test_boundary.py:test_soft_pose_fit_recovers_offset`` (60 Adam
steps from a 0.3 offset to under 1e-2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.diff import transforms as jax_transforms
from pathtracerpython_tpu.ops.camera import (
    make_primary_rays as jax_make_primary_rays,
)
from pathtracerpython_tpu.render.config import RenderConfig as JaxConfig
from pathtracerpython_tpu.render.integrator import (
    render_rays as jax_render_rays,
)
from pathtracerpython_tpu_torch.apps import fit_camera, fit_pose
from pathtracerpython_tpu_torch.diff import adam
from pathtracerpython_tpu_torch.diff.transforms import translate_object
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import render_rays
from pathtracerpython_tpu_torch.scene import arrays, synthetic
from torch_boundary_parity import near_tie_lanes
from torch_parity import pack_pair


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the other test workers'
    cores free."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_find_object_index_on_the_stand_in():
    desc = synthetic.cornell_box_scene(8, 8)
    assert fit_pose.find_object_index(desc, "cube") == 5
    assert fit_pose.find_object_index(desc, "cube2") == 6
    assert fit_pose.find_object_index(desc, "floor") == 2
    with pytest.raises(ValueError, match="teapot"):
        fit_pose.find_object_index(desc, "teapot")


@pytest.mark.parametrize("soft_beta,start,stages", [
    (0.03, None, 4), (0.03, 0.2, 3), (0.05, None, 1), (0.02, None, 2)])
def test_beta_schedule_is_jax_formula(soft_beta, start, stages):
    """``apps/fit_pose.py:162-168`` of the JAX package."""
    s = 4.0 * soft_beta if start is None else start
    k = max(int(stages), 1)
    want = [float(s * (soft_beta / s) ** (i / max(k - 1, 1)))
            for i in range(k)] if k > 1 else [soft_beta]
    assert fit_pose.beta_schedule(soft_beta, start, stages) == want
    assert fit_pose.beta_schedule(soft_beta, start, stages)[-1] == (
        pytest.approx(soft_beta))


@pytest.mark.parametrize("w,h,pyramid", [
    (128, 128, True), (512, 256, True), (95, 200, True), (40, 40, True),
    (128, 128, False), (100, 96, True)])
def test_pyramid_levels_are_jax_formula(w, h, pyramid):
    """``apps/fit_pose.py:203-205`` of the JAX package (object mode)."""
    want = [(w, h)]
    if pyramid and min(w, h) >= 96:
        want = [(max(40, w // 4), max(40, h // 4)), (w, h)]
    assert fit_pose.pyramid_levels(w, h, pyramid) == want


def test_object_fit_step0_matches_jax():
    """Loss and gradient of the planar pose (dx, dz, yaw) = (0.4, 0.3,
    0.25) of the occluder scene's blocker against the target at the true
    pose, beta 0.12 (the anneal's first stage), key PRNGKey(0), over the
    pixels whose front record has no coplanar tie in the moved scene: there
    F is picked by the last bit of t, which the packages round apart (see
    ``test_torch_soft_fd.py``)."""
    desc = synthetic.occluder_scene()
    scene, jax_scene = pack_pair(desc)
    beta, key = 0.12, 0
    kw = dict(n_samples=1, n_bounces=1, soft_vis_beta=beta)
    w, h = scene.meta.width, scene.meta.height
    p0 = np.asarray([0.4, 0.3, 0.25], np.float32)

    o, d = jax_make_primary_rays(jax_scene.eye, jax_scene.ortho, w, h)
    pids = jnp.arange(w * h, dtype=jnp.int32)
    jax_cfg = JaxConfig(mode="fast", backend="pallas", **kw)
    jkey = jax.random.PRNGKey(key)
    target = jax_render_rays(o, d, pids, jax_scene, jax_cfg, jkey)

    what, move, to_pose = fit_pose.pose_model(desc, "blocker")
    assert what == "object blocker (#1, planar)"
    rays = (*make_primary_rays(scene.eye, scene.ortho, w, h),
            torch.arange(w * h))
    with torch.no_grad():
        moved = move(scene, *to_pose(torch.from_numpy(p0)))
    tie = near_tie_lanes(rays[0].numpy(), rays[1].numpy(), moved, beta)["f"]
    assert tie.sum() <= 12  # 6 of the 144 pixels
    keep = (~tie).astype(np.float32)[:, None] * tie.size / (~tie).sum()

    def jax_loss(p):
        moved = jax_transforms.transform_object(
            jax_scene, 1, jnp.stack([p[0], 0.0, p[1]]), p[2])
        rad = jax_render_rays(o, d, pids, moved, jax_cfg, jkey)
        return 0.5 * jnp.mean((rad - target) ** 2 * keep)

    lj, gj = jax.jit(jax.value_and_grad(jax_loss))(jnp.asarray(p0))

    cfg = RenderConfig(**kw)
    with torch.no_grad():
        target_p = render_rays(*rays, scene, cfg, (0, key))
    np.testing.assert_allclose(target_p.numpy(), np.asarray(target),
                               rtol=1e-5, atol=1e-5)
    params = torch.from_numpy(p0).requires_grad_(True)
    off, ang = to_pose(params)
    rad = render_rays(*rays, move(scene, off, ang), cfg, (0, key))
    loss = 0.5 * ((rad - target_p) ** 2 * torch.from_numpy(keep)).mean()
    loss.backward()
    assert abs(loss.item() - float(lj)) <= 1e-6 * abs(float(lj))
    gp, gj = params.grad.numpy(), np.asarray(gj)
    assert np.abs(gj).min() > 0
    assert np.linalg.norm(gp - gj) <= 1e-5 * np.linalg.norm(gj), (gp, gj)


def _losses(out_dir):
    import json
    import os

    with open(os.path.join(out_dir, "result.json")) as f:
        return json.load(f)["losses"]


def test_light_fit_loss_falls(tmp_path):
    """Light mode on the stand-in at 128x128 (hard estimator), 3 steps."""
    result = fit_pose.run(steps=3, out_dir=str(tmp_path), device="cpu",
                          log=lambda _: None)
    losses = _losses(tmp_path)
    assert result["mode"] == "light" and len(losses) == 3
    assert losses[-1] < losses[0]
    assert result["final_offset_norm"] < result["init_offset_norm"]


def test_object_fit_loss_falls(tmp_path):
    """Object mode on the occluder scene (12x12: no pyramid), 4 beta
    stages of 2 steps."""
    result = fit_pose.run(object_name="blocker", steps=8, init_angle=0.1,
                          init_offset=(0.2, 0.0, 0.1), soft_beta=0.05,
                          desc=synthetic.occluder_scene(),
                          out_dir=str(tmp_path), device="cpu",
                          log=lambda _: None)
    losses = _losses(tmp_path)
    assert result["levels"] == [(12, 12)] and len(result["betas"]) == 4
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert result["final_offset_norm"] < result["init_offset_norm"]


def test_camera_fit_loss_falls(tmp_path):
    """``fit_camera`` on the stand-in at 128x128, 3 steps."""
    result = fit_camera.run(steps=3, out_dir=str(tmp_path), device="cpu",
                            log=lambda _: None)
    losses = _losses(tmp_path)
    assert len(losses) == 3 and losses[-1] < losses[0]
    assert result["eye_err_final"] < result["eye_err_initial"]


def test_soft_pose_fit_recovers_offset():
    """60 Adam steps (lr 0.05) driven by soft-visibility gradients recover
    a 0.3 blocker offset along x to under 1e-2."""
    scene = arrays.pack_scene(synthetic.occluder_scene(), device="cpu")
    cfg = RenderConfig(n_bounces=1, n_light_samples=2, soft_vis_beta=0.05)
    w, h = scene.meta.width, scene.meta.height
    o, d = make_primary_rays(scene.eye, scene.ortho, w, h)
    pids = torch.arange(w * h)
    with torch.no_grad():
        target = render_rays(o, d, pids, scene, cfg, 5)
    dx = torch.tensor(0.3, requires_grad=True)
    opt = adam(0.05)([dx])
    for _ in range(60):
        opt.zero_grad()
        moved = translate_object(
            scene, 1, torch.stack([dx, torch.zeros(()), torch.zeros(())]))
        rad = render_rays(o, d, pids, moved, cfg, 5)
        (0.5 * ((rad - target) ** 2).mean()).backward()
        opt.step()
    assert abs(float(dx)) < 1e-2, float(dx)
