"""Shared helpers of the gradient parity tests: one loss and its gradients
over a params dict, computed by the JAX package (``jax.value_and_grad``,
``backend="pallas"``, its Pallas kernels in interpret mode and their custom
VJPs in plain JAX) and by the port (``torch.autograd`` on the CPU, the
kernels' plain versions under ``NearestTIdx`` and ``NeeMeanCos``), on the
same scene, rays, target and key, all made with numpy from a seed.

Tolerances: the two run the same float32 estimator on the same random
numbers and re-solve the same winners, but XLA:CPU fuses products into
adds and rounds rsqrt, sin and cos unlike PyTorch, so values differ in the
last bits: measured, losses to 2e-7 relative and gradients to 1e-6 in
relative L2 per field. The bounds are LOSS_RTOL = 1e-6 and GRAD_RTOL =
1e-4 per field, with GRAD_ATOL = 1e-9 for a field whose gradient is zero
in both (mat_kt, or ks with no specular surface)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pathtracerpython_tpu.diff import inverse as jax_inverse
from pathtracerpython_tpu.kernels import intersect_pallas as ip
from pathtracerpython_tpu.render.config import RenderConfig as JaxConfig
from pathtracerpython_tpu_torch.diff import inverse
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.render.config import RenderConfig

LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-4
GRAD_ATOL = 1e-9
SEED = 3

SCENE_FIELDS = ("mat_rgb", "mat_ka", "mat_kd", "mat_ks", "mat_kt", "mat_n",
                "light_color", "ambient", "tri_v0", "tri_v1", "tri_v2",
                "light_v0", "light_v1", "light_v2")
# The camera the camera losses start from, off the scene's own (as
# tests/test_diff.py's camera tests start), so that the loss and its
# gradients are informative.
EYE_OFFSET = (0.03, -0.02, 0.05)
ORTHO_OFFSET = (0.02, 0.0, -0.03, 0.01)


def center_rays(n: int = 4):
    """tests/test_diff.py's ray grid through the window region (x, y near
    -0.5) that hits the flat scene's floor inside: (origins, dirs) f32[n*n,
    3] as numpy."""
    xs = np.linspace(-0.2, 0.2, n, dtype=np.float32)
    ys = np.linspace(-0.6, -0.4, n, dtype=np.float32)
    x, y = np.meshgrid(xs, ys, indexing="ij")
    pts = np.stack([x.ravel(), y.ravel(), np.zeros(n * n, np.float32)], -1)
    eye = np.asarray([0.0, 0.0, 3.0], np.float32)
    return np.broadcast_to(eye, pts.shape).copy(), (pts - eye).astype(
        np.float32)


def start_params(jax_scene, camera: bool) -> dict[str, np.ndarray]:
    """Every field of a case as numpy: the scene's own values, and with
    ``camera`` the offset eye and ortho."""
    params = {f: np.array(getattr(jax_scene, f)) for f in SCENE_FIELDS}
    if camera:
        params["eye"] = (np.asarray(jax_scene.eye)
                         + np.asarray(EYE_OFFSET, np.float32))
        params["ortho"] = (np.asarray(jax_scene.ortho)
                           + np.asarray(ORTHO_OFFSET, np.float32))
    return params


def jax_value_and_grad(jax_scene, cfg_kw, params, target, rays, mt_impl):
    """(loss, {field: grad}) of the JAX package: ``camera_pixel_loss`` when
    ``rays`` is None, else ``pixel_loss`` on those rays."""
    cfg = JaxConfig(mode="fast", backend="pallas", **cfg_kw)
    render_fn = jax_inverse.make_render_fn(cfg)
    key = jax.random.PRNGKey(SEED)
    target = jnp.asarray(target)
    n = target.shape[0]
    pids = jnp.arange(n, dtype=jnp.int32)

    def f(p):
        if rays is None:
            return jax_inverse.camera_pixel_loss(p, jax_scene, target,
                                                 render_fn, pids, key)
        return jax_inverse.pixel_loss(p, jax_scene, target, render_fn,
                                      jnp.asarray(rays[0]),
                                      jnp.asarray(rays[1]), pids, key)

    before = ip.MT_IMPL
    ip.MT_IMPL = mt_impl
    try:
        loss, grads = jax.value_and_grad(f)(
            {k: jnp.asarray(v) for k, v in params.items()})
    finally:
        ip.MT_IMPL = before
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def port_value_and_grad(scene, cfg_kw, params, target, rays, mt_impl):
    """(loss, {field: grad}) of the port on the CPU, as
    ``jax_value_and_grad``."""
    cfg = RenderConfig(mode="fast", mt_impl=mt_impl, **cfg_kw)
    render_fn = inverse.make_render_fn(cfg)
    leaves = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
              for k, v in params.items()}
    target = torch.from_numpy(np.array(target))
    pids = torch.arange(target.shape[0])
    key = (0, SEED)
    if rays is None:
        loss = inverse.camera_pixel_loss(leaves, scene, target, render_fn,
                                         pids, key)
    else:
        loss = inverse.pixel_loss(leaves, scene, target, render_fn,
                                  torch.from_numpy(rays[0]),
                                  torch.from_numpy(rays[1]), pids, key)
    loss.backward()
    # a field the loss does not read (mat_kt in fast mode) gets no grad
    # at all, where JAX gives zeros
    return float(loss.detach()), {k: (np.zeros(v.shape, np.float32) if v.grad is None
                             else v.grad.numpy()) for k, v in leaves.items()}


def case_inputs(scene, jax_scene, camera: bool, rays=None, seed: int = 0):
    """(params, target, rays) of a case: ``rays`` None with ``camera``
    (the scene's own view), else the given rays or the scene's primary
    rays; the target uniform in [0, 0.5) from ``seed``."""
    params = start_params(jax_scene, camera)
    if not camera and rays is None:
        o, d = make_primary_rays(scene.eye, scene.ortho, scene.meta.width,
                                 scene.meta.height)
        rays = (o.numpy().copy(), d.numpy().copy())
    n = (scene.meta.width * scene.meta.height if camera
         else rays[0].shape[0])
    target = np.random.default_rng(seed).uniform(
        0.0, 0.5, (n, 3)).astype(np.float32)
    return params, target, (None if camera else rays)


def hold_grads(got: dict, want: dict, loss_got: float, loss_want: float):
    """The bounds of the module docstring; returns the worst relative L2."""
    assert abs(loss_got - loss_want) <= LOSS_RTOL * abs(loss_want), (
        loss_got, loss_want)
    worst = 0.0
    assert set(got) == set(want)
    nonzero = 0
    for field, w in want.items():
        g = got[field]
        assert g.shape == w.shape and np.isfinite(g).all(), field
        err = float(np.linalg.norm(g - w))
        scale = float(np.linalg.norm(w))
        assert err <= GRAD_RTOL * scale + GRAD_ATOL, (field, err, scale)
        if scale > 0:
            nonzero += 1
            worst = max(worst, err / scale)
    assert nonzero >= len(want) // 2, "too few fields carry a gradient"
    return worst


def run_case(scene, jax_scene, cfg_kw, camera: bool, mt_impl="classic",
             rays=None):
    """One parity case end to end: loss and gradients of both packages
    held by ``hold_grads``. (A ray that grazes an edge can flip a winner
    between the two and move the loss by a whole light's color on a pixel;
    the loss bound would show it. The cases' rays graze none.)"""
    params, target, rays = case_inputs(scene, jax_scene, camera, rays)
    lp, gp = port_value_and_grad(scene, cfg_kw, params, target, rays,
                                 mt_impl)
    lj, gj = jax_value_and_grad(jax_scene, cfg_kw, params, target, rays,
                                mt_impl)
    return hold_grads(gp, gj, lp, lj)
