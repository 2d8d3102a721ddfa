"""Sharded rendering: rays over the data-parallel mesh axes, triangles over
the geometry axis (the JAX package's ``parallel/shard.py`` on
``torch.distributed``).

Every rank receives the whole (replicated) primary rays, renders the
contiguous slice of them its place on the ray axes (dp, then geom) names,
with their GLOBAL pixel ids, so every lane draws the RNG stream of the
single-device render, and all-gathers the radiance: every rank returns the
whole [N, 3]. With a geometry axis each rank holds one shard of the
``TRI_FIELDS`` and the sweeps stream the shards around the ring
(``parallel/ring.py``); the geom axis then doubles as ray parallelism, as
in JAX. A dp render equals the single-device render bit for bit; a ring
render sweeps each shard with the same kernels and merges by (key, global
row), so it names the same winners.

The gather is differentiable (``GatherRays``): its backward keeps this
rank's slice of the radiance's gradient, so a loss computed on the whole
image on every rank back-propagates into this rank's rays only, and the
parameters' gradients are summed over the ray axes
(``diff.inverse.make_train_step``).
"""

from __future__ import annotations

import dataclasses

import torch

from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.parallel import mesh as mesh_mod
from pathtracerpython_tpu_torch.parallel.multihost import transport
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import (
    check_counter_space,
    render_rays,
)
from pathtracerpython_tpu_torch.scene.arrays import SceneTensors, TRI_FIELDS


def ray_axes(dp_axis: str = "dp", geom_axis: str | None = None) -> tuple:
    """The mesh axes a ray batch is split over: ``dp_axis``, then
    ``geom_axis``."""
    return (dp_axis,) + ((geom_axis,) if geom_axis is not None else ())


def shard_scene(scene: SceneTensors, mesh: mesh_mod.Mesh,
                geom_axis: str | None) -> SceneTensors:
    """This rank's part of the scene (the counterpart of JAX's
    ``scene_partition_specs``): the ``TRI_FIELDS`` sliced along
    ``geom_axis`` into contiguous shards of equal rows, every other field
    whole. The padded triangle count must divide by the axis' size
    (``ValueError`` otherwise; pack with another ``pad_to``)."""
    if geom_axis is None:
        return scene
    n = mesh.shape[geom_axis]
    rows = scene.num_padded_triangles
    if rows % n:
        raise ValueError(
            f"{rows} padded triangles do not divide into {n} shards of the "
            f"geom axis; pack the scene with pad_to a multiple of {n}")
    per = rows // n
    lo = mesh.coords[geom_axis] * per
    return dataclasses.replace(scene, **{
        f: getattr(scene, f)[lo:lo + per] for f in TRI_FIELDS})


class GatherRays(torch.autograd.Function):
    """All-gather of each rank's [rows, ...] radiance along dim 0 over a
    process group; the backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, local, group, index):
        ctx.index, ctx.rows = index, local.shape[0]
        return transport("all_gather", local, group)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.index * ctx.rows
        return grad[lo:lo + ctx.rows], None, None


def gather_rays(local: torch.Tensor, mesh: mesh_mod.Mesh,
                axes: tuple) -> torch.Tensor:
    """The ranks' slices along ``axes`` in ray order (``local`` itself on a
    line of one rank)."""
    group, ranks = mesh.line(axes)
    if len(ranks) == 1:
        return local
    return GatherRays.apply(local, group, mesh.index(axes))


def render_rays_sharded(origins, directions, pixel_ids, scene: SceneTensors,
                        cfg: RenderConfig, base_key, mesh: mesh_mod.Mesh,
                        dp_axis: str = "dp", geom_axis: str | None = None):
    """Trace the primary rays [N, 3] sharded over the mesh; returns the
    whole radiance [N, 3] on every rank.

    The rays split over ``ray_axes(dp_axis, geom_axis)``: N is padded to a
    multiple of the shard count with copies of ray 0, whose lanes keep
    places of their own (the integrator unscrambles by place, not by pixel
    id) and are cut off the result. ``check_counter_space`` holds the
    global count. With ``geom_axis`` the scene's ``TRI_FIELDS`` split over
    that axis and the sweeps run the ring."""
    axes = ray_axes(dp_axis, geom_axis)
    n_shards = mesh.count(axes)
    n = origins.shape[0]
    check_counter_space(n, cfg.n_samples)
    pad = (-n) % n_shards
    if pad:
        first = torch.zeros(pad, dtype=torch.int64, device=origins.device)
        origins = torch.cat([origins, origins[first]])
        directions = torch.cat([directions, directions[first]])
        pixel_ids = torch.cat([pixel_ids, pixel_ids[first]])
    per = (n + pad) // n_shards
    lo = mesh.index(axes) * per
    if geom_axis is not None:
        scene = shard_scene(scene, mesh, geom_axis)
        cfg = dataclasses.replace(cfg, geom_axis=geom_axis,
                                  geom_axis_size=mesh.shape[geom_axis])
    with mesh_mod.active(mesh):
        local = render_rays(origins[lo:lo + per], directions[lo:lo + per],
                            pixel_ids[lo:lo + per], scene, cfg, base_key)
    out = gather_rays(local, mesh, axes)
    return out[:n] if pad else out


def render_sharded(scene: SceneTensors, cfg: RenderConfig,
                   mesh: mesh_mod.Mesh, seed: int = 0, dp_axis: str = "dp",
                   geom_axis: str | None = None) -> torch.Tensor:
    """Sharded render of the scene's camera view: radiance [W*H, 3] in the
    reference's pixel order on every rank, the distributed form of
    ``render.integrator.render``."""
    w, h = scene.meta.width, scene.meta.height
    check_counter_space(w * h, cfg.n_samples)
    origins, dirs = make_primary_rays(scene.eye, scene.ortho, w, h)
    pixel_ids = torch.arange(w * h, dtype=torch.int64, device=scene.device)
    return render_rays_sharded(origins, dirs, pixel_ids, scene, cfg, seed,
                               mesh, dp_axis=dp_axis, geom_axis=geom_axis)
