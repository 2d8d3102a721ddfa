"""The port's soft-estimator render (``soft_vis_beta > 0``) against the JAX
package's ``render_rays(..., backend="pallas")`` on the same scene, rays,
key and config: the occluder scene of ``tests/test_boundary.py`` at 12x12
and the Cornell stand-in at 16x16, 1-2 spp and 1-2 bounces, and a box field
past 4,096 rows, where the cluster sweeps run and the wavefront is sorted
and parked as in the JAX package.

Tolerances: radiance within rtol = atol = 1e-5 on every pixel; losses
within 1e-6 relative; gradients within 1e-5 relative L2 for the rigid
translation of the blocker (the occluder scene's material row 1) and of
the stand-in's tall cube (row 5), and for ``tri_v0`` on the stand-in at 1
spp and 1 bounce. Per-vertex gradients of the occluder scene are not held
to that bound: a shadow ray through the interior of one quad sums
sigmoid(m) + sigmoid(-m), which is 1 up to rounding, at the kink of
``min(cov, 1)``, whose gradient (0, 1/2 or 1) follows the last bit of the
sum, which the packages round apart (measured 0.8-1.0% relative L2 on
``tri_v0``). A rigid motion keeps m and -m paired, so the kink's lanes add
nothing to its gradient; ``test_torch_boundary.py`` holds the per-vertex
visibility gradient away from the kink."""

import dataclasses

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
from pathtracerpython_tpu.render.integrator import render as jax_render
from pathtracerpython_tpu.render.integrator import (
    render_rays as jax_render_rays,
)
from pathtracerpython_tpu.scene.arrays import (
    recompute_derived as jax_recompute_derived,
)
from pathtracerpython_tpu_torch.diff import transforms
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import render, render_rays
from pathtracerpython_tpu_torch.scene import synthetic
from pathtracerpython_tpu_torch.scene.arrays import recompute_derived
from torch_parity import pack_pair

BETA = 0.05
RTOL = ATOL = 1e-5
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
SEED = 3
# scene -> (description, the material row of the object that moves)
SCENES = {"occluder": (synthetic.occluder_scene, 1),
          "cornell": (lambda: synthetic.cornell_box_scene(16, 16), 5)}
PLANS = {"1spp1b": (1, 1), "2spp2b": (2, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the other test workers'
    cores free."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scenes():
    return {k: pack_pair(make()) for k, (make, _) in SCENES.items()}


def _cfg_kw(plan):
    spp, bounces = PLANS[plan]
    return dict(n_samples=spp, n_bounces=bounces, n_light_samples=2,
                soft_vis_beta=BETA)


def test_soft_batch_samples_equals_sample_loop(scenes):
    """Both sample plans draw the same numbers: the same radiance."""
    scene, _ = scenes["cornell"]
    kw = _cfg_kw("2spp2b")
    loop = render(scene, RenderConfig(**kw), seed=SEED)
    batch = render(scene, RenderConfig(batch_samples=True, **kw), seed=SEED)
    torch.testing.assert_close(batch, loop, rtol=0, atol=1e-6)


def _losses(scene, jax_scene, kw, move, jax_move, p0):
    """(port loss, port grad, port radiance, JAX loss, JAX grad, JAX
    radiance) of 0.5 * mean squared error against a seeded target, at the
    params ``p0``."""
    w, h = scene.meta.width, scene.meta.height
    target = np.random.default_rng(0).uniform(0.0, 0.5, (w * h, 3)).astype(
        np.float32)
    o, d = jax_make_primary_rays(jax_scene.eye, jax_scene.ortho, w, h)
    pids = jnp.arange(w * h, dtype=jnp.int32)
    cfg = JaxConfig(mode="fast", backend="pallas", **kw)

    def jax_loss(p):
        rad = jax_render_rays(o, d, pids, jax_move(p), cfg,
                              jax.random.PRNGKey(SEED))
        return 0.5 * jnp.mean((rad - target) ** 2), rad

    (lj, radj), gj = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        jnp.asarray(p0))
    po, pd = make_primary_rays(scene.eye, scene.ortho, w, h)
    p = torch.from_numpy(np.array(p0)).requires_grad_(True)
    rad = render_rays(po, pd, torch.arange(w * h), move(p),
                      RenderConfig(**kw), (0, SEED))
    lp = 0.5 * ((rad - torch.from_numpy(target)) ** 2).mean()
    lp.backward()
    return (lp.item(), p.grad.numpy(), rad.detach().numpy(), float(lj),
            np.asarray(gj), np.asarray(radj))


def _hold(lp, gp, radp, lj, gj, radj):
    np.testing.assert_allclose(radp, radj, rtol=RTOL, atol=ATOL)
    assert abs(lp - lj) <= LOSS_RTOL * abs(lj), (lp, lj)
    assert np.linalg.norm(gj) > 0 and np.isfinite(gp).all()
    err = np.linalg.norm(gp - gj) / np.linalg.norm(gj)
    assert err <= GRAD_RTOL, err


@pytest.mark.parametrize("plan", sorted(PLANS))
@pytest.mark.parametrize("which", sorted(SCENES))
def test_soft_render_and_translation_grads_match_jax(scenes, which, plan):
    """With the moving object translated by (0.05, 0, -0.03): the radiance,
    the loss and d loss / d (dx, dz), which holds the silhouette and
    shadow-edge terms the hard estimator lacks."""
    scene, jax_scene = scenes[which]
    obj = SCENES[which][1]

    def move(p):
        return transforms.translate_object(
            scene, obj, torch.stack([p[0], torch.zeros(()), p[1]]))

    def jax_move(p):
        return jax_transforms.translate_object(
            jax_scene, obj, jnp.stack([p[0], 0.0, p[1]]))

    _hold(*_losses(scene, jax_scene, _cfg_kw(plan), move, jax_move,
                   np.asarray([0.05, -0.03], np.float32)))


def test_soft_vertex_grads_match_jax(scenes):
    """d loss / d tri_v0 on the stand-in (1 spp, 1 bounce)."""
    scene, jax_scene = scenes["cornell"]

    def move(v0):
        return recompute_derived(dataclasses.replace(scene, tri_v0=v0))

    def jax_move(v0):
        return jax_recompute_derived(dataclasses.replace(jax_scene,
                                                         tri_v0=v0))

    _hold(*_losses(scene, jax_scene, _cfg_kw("1spp1b"), move, jax_move,
                   np.asarray(jax_scene.tri_v0)))


def test_soft_render_sorted_large_scene_matches_jax():
    """A 400-box field (4,804 triangles, morton order): ``accel="auto"``
    sorts and parks the wavefront, the soft sweeps run on the clusters
    (JAX's cluster sweeps miss some near-misses, finding 1, but none on
    these rays), and the soft NEE keeps its shadow lanes unsorted."""
    scene, jax_scene = pack_pair(synthetic.box_field_scene(
        n_boxes=400, width=8, height=8), tri_order="morton")
    kw = dict(n_samples=1, n_bounces=2, n_light_samples=2,
              soft_vis_beta=0.03)
    got = render(scene, RenderConfig(**kw), seed=SEED).numpy()
    want = np.asarray(jax_render(jax_scene, JaxConfig(
        mode="fast", backend="pallas", **kw), seed=SEED))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
