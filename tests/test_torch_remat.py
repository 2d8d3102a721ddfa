"""``RenderConfig(remat_bounces=True)``: each bounce under
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` over the
bounce body). On the CPU the recompute runs the same float ops in the same
order, so losses and gradients are bit-equal with and without it
(``tests/test_diff.py::test_remat_bounces_gradients_match`` holds the JAX
package's to 1e-5), and the nearest sweep and the fused NEE run twice per
bounce: once in the forward, once in the backward's recompute. On the card
that doubles K1's and K2's launches (``tests/test_torch_cuda.py``); here
the plain versions' calls are counted.

Mirrored on the flat scene of ``tests/test_diff.py`` with its center rays,
and held also with vertex and camera parameters, with the soft estimator,
and with the occluder cache (``nee_cache="on"``, which reads the host once
a bounce and so once more in the recompute) on a small box field."""

import dataclasses

import pytest
import torch

from pathtracerpython_tpu_torch.diff import (
    camera_pixel_loss,
    make_render_fn,
    pixel_loss,
)
from pathtracerpython_tpu_torch.kernels import intersect, nee
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import render
from pathtracerpython_tpu_torch.scene import arrays, synthetic

KEY = (0, 0)  # jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the other test workers'
    cores free."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def sweep_calls(monkeypatch):
    """Counts of the plain nearest sweep's and the plain fused NEE's calls,
    the CPU's stand-ins of K1's and K2's launches."""
    calls = {"nearest": 0, "nee": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(intersect, "nearest_t_idx_plain",
                        counted("nearest", intersect.nearest_t_idx_plain))
    monkeypatch.setattr(nee, "nee_mean_cos_plain",
                        counted("nee", nee.nee_mean_cos_plain))
    return calls


def center_rays(n=4):
    """tests/test_diff.py's rays through the window region that hit the
    flat scene's floor inside."""
    xs = torch.linspace(-0.2, 0.2, n)
    ys = torch.linspace(-0.6, -0.4, n)
    x, y = torch.meshgrid(xs, ys, indexing="ij")
    pts = torch.stack([x.ravel(), y.ravel(), torch.zeros(n * n)], dim=-1)
    eye = torch.tensor([0.0, 0.0, 3.0])
    return eye.expand(pts.shape), pts - eye


def grads(loss_fn, params: dict):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    loss = loss_fn(leaves)
    loss.backward()
    return loss.detach(), {k: v.grad for k, v in leaves.items()}


def hold_bit_equal(loss_fn_of_cfg, cfg, params):
    """(loss, grads) with and without remat, bit for bit."""
    base = grads(loss_fn_of_cfg(cfg), params)
    remat = grads(loss_fn_of_cfg(dataclasses.replace(
        cfg, remat_bounces=True)), params)
    assert torch.equal(base[0], remat[0])
    for k in params:
        assert torch.equal(base[1][k], remat[1][k]), k
        assert base[1][k].abs().sum() > 0, k


def test_remat_bounces_gradients_match(sweep_calls):
    """The flat scene's center rays, 3 bounces, mat_rgb: bit-equal, and
    each bounce's nearest sweep and NEE run once more in the backward."""
    scene = arrays.pack_scene(synthetic.flat_scene(), device="cpu")
    origins, dirs = center_rays()
    pids = torch.arange(origins.shape[0])
    target = torch.zeros((origins.shape[0], 3))
    cfg = RenderConfig(n_samples=1, n_bounces=3, n_light_samples=2)

    def loss_fn(cfg):
        return lambda p: pixel_loss(p, scene, target, make_render_fn(cfg),
                                    origins, dirs, pids, KEY)

    params = {"mat_rgb": scene.mat_rgb}
    grads(loss_fn(cfg), params)
    plain = dict(sweep_calls)
    assert plain == {"nearest": 3, "nee": 3}
    hold_bit_equal(loss_fn, cfg, params)
    assert sweep_calls == {"nearest": 3 + 3 + 6, "nee": 3 + 3 + 6}


def _camera_loss(scene, cfg_kw):
    with torch.no_grad():
        target = 0.5 * render(scene, RenderConfig(**cfg_kw), seed=1)
    pids = torch.arange(target.shape[0])

    def loss_fn(cfg):
        return lambda p: camera_pixel_loss(p, scene, target,
                                           make_render_fn(cfg), pids, (0, 4))

    return loss_fn


def test_remat_vertex_and_camera_grads_bit_equal(sweep_calls):
    """The Cornell stand-in at 8x8, 2 spp as extra lanes, 2 bounces:
    vertex, light and camera parameters (the nearest sweep under
    NearestTIdx, the fused NEE under NeeMeanCos)."""
    scene = arrays.pack_scene(synthetic.cornell_box_scene(8, 8), pad_to=32,
                              device="cpu")
    kw = dict(n_samples=2, n_bounces=2, batch_samples=True)
    params = {f: getattr(scene, f) for f in ("tri_v0", "light_v0",
                                             "mat_rgb", "ortho")}
    params["eye"] = scene.eye + torch.tensor([0.03, -0.02, 0.05])
    before = dict(sweep_calls)
    hold_bit_equal(_camera_loss(scene, kw), RenderConfig(**kw), params)
    # the target render and the two steps' forwards: 2 bounces each, and
    # the remat step's recompute 2 more
    assert sweep_calls["nearest"] - before["nearest"] == 2 + 2 + 2 + 2
    assert sweep_calls["nee"] - before["nee"] == 2 + 2 + 2 + 2


def test_remat_soft_grads_bit_equal():
    """The soft estimator (no kernel; its tiles under their own
    checkpoints) on the occluder scene, 2 bounces."""
    scene = arrays.pack_scene(synthetic.occluder_scene(), device="cpu")
    kw = dict(n_bounces=2, n_light_samples=2, soft_vis_beta=0.05)
    params = {f: getattr(scene, f) for f in ("tri_v0", "tri_v1", "mat_rgb")}
    hold_bit_equal(_camera_loss(scene, kw), RenderConfig(**kw), params)


def test_remat_with_occluder_cache_bit_equal():
    """The occluder cache on a 400-box field (accel="sparse",
    nee_cache="on"): K7's two passes read the open lanes' count on the
    host once a bounce, and the recompute reads it again from the same
    cache, so it takes the same branch."""
    scene = arrays.pack_scene(synthetic.box_field_scene(
        n_boxes=400, width=8, height=8), tri_order="morton", device="cpu")
    kw = dict(n_bounces=3, accel="sparse", nee_cache="on")
    params = {f: getattr(scene, f) for f in ("tri_v0", "mat_rgb",
                                             "light_color")}
    hold_bit_equal(_camera_loss(scene, kw), RenderConfig(**kw), params)
