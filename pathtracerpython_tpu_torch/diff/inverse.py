"""Inverse rendering: differentiate the wavefront integrator with respect to
scene parameters and fit them to target images, as the JAX package's
``diff/inverse.py`` does, with ``torch.autograd`` and ``torch.optim``.

Parameters are a dict of ``SceneTensors`` field overrides (tensors that
require grad). Supported:

- material fields (``mat_rgb``, ``mat_ka``, ``mat_kd``, ``mat_ks``,
  ``mat_kt``, ``mat_n``): gradients through the shading math;
- emission (``light_color``, ``ambient``);
- vertex buffers (``tri_v0/1/2``, ``light_v0/1/2``): gradients through the
  hit distance, the shading point and, by ``recompute_derived``, the
  normals. With the hard estimator discrete choices (winners, occlusion,
  BRDF branch, light pick) carry no gradient, as in the JAX package;
  ``RenderConfig.soft_vis_beta > 0`` switches to the soft boundary
  estimator (``diff/boundary.py``), whose silhouette and shadow terms are
  differentiable in occluder vertices;
- camera (``eye``, ``ortho``): through primary rays made inside the loss
  (``camera_pixel_loss``).

The RNG is counter-based and fixed by (key, pixel, sample, bounce), so a
loss is a deterministic function of the parameters, and central finite
differences with one key are a valid oracle of its gradient.

``make_render_fn``, ``make_train_step`` and ``fit`` take any config the
integrator renders, the soft estimator and ``remat_bounces`` included.
``fit(checkpoint_dir=, checkpoint_every=)`` checkpoints the params, the
optimizer's state dict and the RNG position and resumes from them, and
refuses a checkpoint of another fit.

Sharded training (``mesh``, ``dp_axis``, ``geom_axis``; the JAX package's
``shard_map`` step): every rank renders its slice of the rays
(``parallel.render_rays_sharded``), the radiance is all-gathered so that
every rank computes the loss on the whole image, each rank's backward
reaches its own rays only (``parallel.shard.GatherRays``), the parameters'
gradients are summed over the ray axes, and every rank takes the same
optimizer step. Under a geometry ring the triangle buffers' gradients
(vertex params, and ``light_v*``, which move the light's rows through
``apply_params``) flow back around the ring (``parallel/ring.py:
RingShift``): each rank's home shard, a slice of the whole parameterized
buffer, collects the gradients of every ray of its ring, and the sum over
the ray axes dp x geom then adds each dp ring's contribution once. The
light's sampling buffers, which every rank holds whole, take their
gradients from the rank's own rays, summed the same way.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Callable

import torch

from pathtracerpython_tpu_torch.ops import rng
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import render_rays
from pathtracerpython_tpu_torch.scene.arrays import (
    SceneTensors,
    recompute_derived,
)
from pathtracerpython_tpu_torch.utils.metrics import span

# Fields that may appear in a params dict.
MATERIAL_FIELDS = ("mat_rgb", "mat_ka", "mat_kd", "mat_ks", "mat_kt", "mat_n")
EMISSION_FIELDS = ("light_color", "ambient")
VERTEX_FIELDS = (
    "tri_v0", "tri_v1", "tri_v2", "light_v0", "light_v1", "light_v2",
)
# Camera parameters: primary rays are made inside the loss from the
# parameterized scene (``camera_pixel_loss``); ``pixel_loss`` takes the
# caller's rays, cannot see them and refuses them.
CAMERA_FIELDS = ("eye", "ortho")
PARAM_FIELDS = MATERIAL_FIELDS + EMISSION_FIELDS + VERTEX_FIELDS + CAMERA_FIELDS

_LIGHT_TO_TRI = {"light_v0": "tri_v0", "light_v1": "tri_v1",
                 "light_v2": "tri_v2"}


def apply_params(scene: SceneTensors, params: dict) -> SceneTensors:
    """Overlay a params dict onto the scene; normals and areas are derived
    again when vertices moved, so that their gradients flow too.

    The light's geometry exists twice (the NEE's sampling buffers and its
    rows in the triangle buffer, which hits and occlusion read); a
    ``light_v*`` override moves both through ``scene.light_tri_rows``, by an
    out-of-place ``index_copy`` (no leaf is written in place)."""
    unknown = set(params) - set(PARAM_FIELDS)
    if unknown:
        raise ValueError(f"unknown scene parameters: {sorted(unknown)}")
    scene = dataclasses.replace(scene, **params)
    rows = scene.light_tri_rows.to(torch.int64)
    sync = {}
    for lf, tf in _LIGHT_TO_TRI.items():
        if lf in params:
            tri = sync.get(tf, getattr(scene, tf))
            sync[tf] = tri.index_copy(0, rows, params[lf])
    if sync:
        scene = dataclasses.replace(scene, **sync)
    if any(f in params for f in VERTEX_FIELDS):
        scene = recompute_derived(scene)
    return scene


def make_render_fn(cfg: RenderConfig, mesh=None, dp_axis: str = "dp",
                   geom_axis: str | None = None) -> Callable:
    """A renderer ``(origins, dirs, pixel_ids, scene, key) -> radiance`` on
    the scene's device; with a ``mesh``, sharded over its ray axes (and the
    triangles over ``geom_axis``), the whole radiance on every rank."""
    if mesh is None:
        return lambda o, d, p, sc, key: render_rays(o, d, p, sc, cfg, key)
    from pathtracerpython_tpu_torch.parallel.shard import render_rays_sharded

    return lambda o, d, p, sc, key: render_rays_sharded(
        o, d, p, sc, cfg, key, mesh, dp_axis=dp_axis, geom_axis=geom_axis)


def pixel_loss(params: dict, base_scene: SceneTensors, target: torch.Tensor,
               render_fn: Callable, origins: torch.Tensor,
               directions: torch.Tensor, pixel_ids: torch.Tensor,
               key) -> torch.Tensor:
    """0.5 * mean squared pixel error of the parameterized render against
    ``target`` for the caller's rays. Camera parameters refuse: fixed rays
    cannot react to them (use ``camera_pixel_loss``)."""
    cam = [f for f in CAMERA_FIELDS if f in params]
    if cam:
        raise ValueError(
            f"camera parameters {cam} need in-loss ray generation; "
            "use camera_pixel_loss / make_train_step"
        )
    scene = apply_params(base_scene, params)
    radiance = render_fn(origins, directions, pixel_ids, scene, key)
    return 0.5 * torch.mean((radiance - target) ** 2)


def camera_pixel_loss(params: dict, base_scene: SceneTensors,
                      target: torch.Tensor, render_fn: Callable,
                      pixel_ids: torch.Tensor, key) -> torch.Tensor:
    """``pixel_loss`` for the scene's own camera view, with the primary rays
    made inside the loss, so that ``eye`` and ``ortho`` are parameters like
    any other (their gradients flow through the ray origins and directions
    into the hit re-solve and the shading geometry)."""
    scene = apply_params(base_scene, params)
    w, h = base_scene.meta.width, base_scene.meta.height
    origins, directions = make_primary_rays(scene.eye, scene.ortho, w, h)
    radiance = render_fn(origins, directions, pixel_ids, scene, key)
    return 0.5 * torch.mean((radiance - target) ** 2)


def adam(lr: float) -> Callable:
    """``optax.adam(lr)`` as a factory of ``torch.optim.Adam`` over a list of
    tensors, with optax's defaults (b1 0.9, b2 0.999, eps 1e-8): the same
    update, rounded in another order."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999),
                             eps=1e-8)


def make_train_step(optimizer: torch.optim.Optimizer,
                    base_scene: SceneTensors, cfg: RenderConfig,
                    target: torch.Tensor, mesh=None, dp_axis: str = "dp",
                    geom_axis: str | None = None) -> Callable:
    """A full training step for the scene's camera view,
    ``step(params, key) -> loss``: ``camera_pixel_loss``, its backward and
    one ``optimizer`` step. ``params`` holds the tensors ``optimizer`` was
    built over, which the step updates in place; the loss comes back as a
    detached 0-d tensor on the scene's device (no host read).

    With a ``mesh`` the render is sharded (``make_render_fn``), the loss is
    the whole image's on every rank, and the gradients are summed over the
    ray axes before the step, so every rank takes the same step."""
    w, h = base_scene.meta.width, base_scene.meta.height
    pixel_ids = torch.arange(w * h, dtype=torch.int64,
                             device=base_scene.device)
    render_fn = make_render_fn(cfg, mesh, dp_axis, geom_axis)
    reduce_grads = None
    if mesh is not None:
        from pathtracerpython_tpu_torch.parallel.multihost import transport
        from pathtracerpython_tpu_torch.parallel.shard import ray_axes

        group, ranks = mesh.line(ray_axes(dp_axis, geom_axis))

        def reduce_grads():
            for g in optimizer.param_groups:
                for p in g["params"]:
                    if p.grad is not None and len(ranks) > 1:
                        p.grad = transport("all_reduce", p.grad, group)

    def train_step(params: dict, key) -> torch.Tensor:
        with span("ptt.step"):
            optimizer.zero_grad(set_to_none=True)
            with span("ptt.forward"):
                loss = camera_pixel_loss(params, base_scene, target,
                                         render_fn, pixel_ids, key)
            with span("ptt.backward"):
                loss.backward()
                if reduce_grads is not None:
                    reduce_grads()
            with span("ptt.optimizer"):
                optimizer.step()
            return loss.detach()

    return train_step


def _fit_identity(params: dict, opt, cfg: RenderConfig,
                  target: torch.Tensor, seed: int) -> dict:
    """What a checkpoint must match for ``fit`` to resume it: the seed, the
    render config, the params' names, shapes and dtypes, the optimizer's
    settings (its param groups without the tensors), and a digest of the
    target's and the starting params' bits."""
    digest = hashlib.sha256()
    for t in (target, *params.values()):
        digest.update(t.detach().cpu().contiguous().numpy().tobytes())
    groups = [{k: v for k, v in g.items() if k != "params"}
              for g in opt.state_dict()["param_groups"]]
    return {"seed": seed, "cfg": repr(cfg),
            "params": [(k, tuple(v.shape), str(v.dtype))
                       for k, v in params.items()],
            "optimizer": repr(groups), "data": digest.hexdigest()}


def fit(params: dict, optimizer: Callable, base_scene: SceneTensors,
        cfg: RenderConfig, target: torch.Tensor, steps: int, seed: int = 0,
        mesh=None, callback=None, checkpoint_dir: str | None = None,
        checkpoint_every: int = 0, dp_axis: str = "dp",
        geom_axis: str | None = None):
    """Run ``steps`` optimizer steps from ``params``; returns (the fitted
    params, detached, and the list of losses of the steps this call ran).

    ``optimizer``: a factory of a ``torch.optim.Optimizer`` over a list of
    tensors, such as ``adam(lr)``. The key walks as in the JAX package's
    ``fit``: key = seed, then per step ``key, sub = split(key)`` and the
    step renders with ``sub``. ``callback(i, params, loss)`` reads the
    loss on the host each step.

    With ``checkpoint_dir`` (JAX ``diff/inverse.py:185-245``) the whole
    training state, the params, the optimizer's ``state_dict`` and the key,
    is saved every ``checkpoint_every`` steps (0: never) as step i + 1, and
    a call that finds a checkpoint there resumes from the latest: a fit
    stopped at step k and resumed gives the uninterrupted fit's params bit
    for bit, on the CPU and on the card (every table gradient is summed by
    ``ops.gather.scatter_rows`` in an order fixed by its inputs, so a step's
    gradients have the same bits on every run). A checkpoint of
    another fit (see ``_fit_identity``), or one past ``steps``, is refused
    with a ``ValueError``. With a ``mesh`` every step is sharded
    (``make_train_step``); only the primary rank writes checkpoints."""
    from pathtracerpython_tpu_torch.parallel.multihost import is_primary
    from pathtracerpython_tpu_torch.utils.checkpoint import CheckpointManager

    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    opt = optimizer(list(params.values()))
    step_fn = make_train_step(opt, base_scene, cfg, target, mesh, dp_axis,
                              geom_axis)
    key = rng.key_from_seed(seed)
    start = 0
    mgr = None
    if checkpoint_dir is not None:
        mgr = CheckpointManager(checkpoint_dir)
        identity = _fit_identity(params, opt, cfg, target, seed)
        latest = mgr.latest_step()
        if latest is not None:
            state = mgr.restore(latest, {"params": params})
            if state.get("identity") != identity:
                raise ValueError(
                    f"the checkpoint at step {latest} in {checkpoint_dir} "
                    "is of another fit (seed, config, params, optimizer "
                    "settings or data differ); use another directory")
            if latest > steps:
                raise ValueError(
                    f"the checkpoint in {checkpoint_dir} is at step "
                    f"{latest}, past steps={steps}")
            with torch.no_grad():
                for k, v in params.items():
                    v.copy_(state["params"][k])
            opt.load_state_dict(state["opt_state"])
            key = tuple(state["key"])
            start = latest
    losses = []
    for i in range(start, steps):
        key, sub = rng.split(key)
        # keep the device scalar: a host read here would wait for the step
        loss = step_fn(params, sub)
        losses.append(loss)
        if (mgr is not None and checkpoint_every > 0
                and (i + 1) % checkpoint_every == 0 and is_primary()):
            mgr.save(i + 1, {
                "params": {k: v.detach() for k, v in params.items()},
                "opt_state": opt.state_dict(),
                "key": key,
                "identity": identity,
            })
        if callback is not None:
            callback(i, params, float(loss))
    return ({k: v.detach() for k, v in params.items()},
            [float(loss) for loss in losses])
