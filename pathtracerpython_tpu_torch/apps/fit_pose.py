"""Inverse rendering demo: recover a pose from a target image through
vertex-position gradients, the JAX package's ``apps/fit_pose.py`` on
PyTorch.

    python -m pathtracerpython_tpu_torch.apps.fit_pose [--steps N]
    python -m pathtracerpython_tpu_torch.apps.fit_pose --object cube
        [--dof planar|full] [--scene SDL] [--device cuda|cpu]

Two modes:

- light (default): the area light's lateral (x, z) position, with the hard
  estimator. The light's vertices enter the NEE smoothly (sample points,
  shadow directions, cosines), so interior gradients suffice; the vertical
  axis is left out, as in the JAX package, whose measurements show the
  loss along it is a flat valley whose gradient points away from the
  truth.
- ``--object <name>``: a rigid pose of the first object whose mesh path
  holds ``name`` (the stand-in's cubes are ``cube1`` and ``cube2``):
  planar (x, z translation and yaw about the centroid) by default, or
  ``--dof full`` (xyz and yaw, pitch, roll). An opaque object moving in its
  own plane has no interior gradient, so this mode runs the soft estimator
  (``RenderConfig.soft_vis_beta``, ``diff/boundary.py``), annealing the
  edge width geometrically over ``--beta-stages`` stages from
  ``--soft-beta-start`` (default 4 x ``--soft-beta``) down to
  ``--soft-beta``. On scenes of 96 pixels and more a resolution pyramid
  first fits at a quarter of the width (at least 40), then at the full
  width; each level reruns the anneal with a fresh Adam, and the target is
  rendered again at each (level, beta), so the optimum stays at zero pose
  error. The result's ``level_params`` hold, for each level, the params
  it started from and those it ended with.

The key is the JAX package's ``PRNGKey(seed)``, (0, seed), fixed for the
whole fit: the loss is a deterministic function of the pose. Runs on the
card unless ``--device cpu`` is given; without a card the default raises.
The scene is ``--scene``, else the in-repo stand-in
``cornell_box_scene(128, 128)``, and the output says which.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

# the CLI's learning rate in object mode: the JAX package tunes the anneal
# at 0.03 (``run``'s default, 0.05, is light mode's)
OBJECT_LR = 0.03


def find_object_index(desc, name_fragment: str) -> int:
    """Index (the material row) of the first object of the
    ``SceneDescription`` whose mesh path's basename holds the fragment."""
    for i, obj in enumerate(desc.objects):
        if name_fragment in os.path.basename(obj.mesh.path):
            return i
    raise ValueError(f"no object matching {name_fragment!r} in "
                     f"{desc.path or 'the scene'}")


def translate_light(scene, offset):
    """Shift the area light by ``offset`` [3]; ``diff.apply_params`` keeps
    the NEE's sampling buffers and the light's rows of the triangle buffer
    together."""
    from pathtracerpython_tpu_torch.diff import apply_params

    return apply_params(scene, {f: getattr(scene, f) + offset
                                for f in ("light_v0", "light_v1",
                                          "light_v2")})


def beta_schedule(soft_beta: float, soft_beta_start: float | None = None,
                  beta_stages: int = 4) -> list[float]:
    """The anneal: geometric from ``soft_beta_start`` (default 4 x
    ``soft_beta``: a 2 x start left the JAX package's cube fit stalled) down
    to ``soft_beta`` over ``beta_stages`` stages."""
    start = 4.0 * soft_beta if soft_beta_start is None else soft_beta_start
    k = max(int(beta_stages), 1)
    if k == 1:
        return [soft_beta]
    return [float(start * (soft_beta / start) ** (i / max(k - 1, 1)))
            for i in range(k)]


def pyramid_levels(width: int, height: int,
                   pyramid: bool = True) -> list[tuple[int, int]]:
    """The object fit's resolution levels: a quarter of the size (at least
    40) and then the full size on scenes of 96 pixels and more."""
    if pyramid and min(width, height) >= 96:
        return [(max(40, width // 4), max(40, height // 4)), (width, height)]
    return [(width, height)]


def stage_steps(steps: int, n_stages: int) -> list[int]:
    """``steps`` split over the stages, the remainder to the last."""
    split = [steps // n_stages] * n_stages
    split[-1] += steps - sum(split)
    return split


def pose_model(desc, object_name: str | None, dof: str = "planar"):
    """(what, move, to_pose) of a mode: ``to_pose(params) -> (offset [3],
    angle)`` and ``move(scene, offset, angle) -> scene``; light mode when
    ``object_name`` is None."""
    import torch

    from pathtracerpython_tpu_torch.diff.transforms import (
        transform_object,
        transform_object_full,
    )

    def lateral(p):
        return torch.stack([p[0], torch.zeros_like(p[0]), p[1]])

    if object_name is None:
        return ("light", lambda sc, off, ang: translate_light(sc, off),
                lambda p: (lateral(p), 0.0))
    idx = find_object_index(desc, object_name)
    what = f"object {object_name} (#{idx}, {dof})"
    if dof == "full":
        return (what, lambda sc, off, ang: transform_object_full(
            sc, idx, off, ang), lambda p: (p[0:3], p[3:6]))
    return (what, lambda sc, off, ang: transform_object(sc, idx, off, ang),
            lambda p: (lateral(p), p[2]))


def initial_params(object_name: str | None, dof: str, init_offset,
                   init_angle: float) -> list[float]:
    """Light: (dx, dz); planar object: (dx, dz, yaw); full: (dx, dy, dz,
    yaw, pitch, roll)."""
    if object_name is None:
        return [init_offset[0], init_offset[2]]
    if dof == "full":
        return [*init_offset, init_angle, 0.0, 0.0]
    return [init_offset[0], init_offset[2], init_angle]


def pose_loss(scene, move, to_pose, cfg, rays, key):
    """``loss(params, target)``: 0.5 * mean squared error of the posed
    scene's render of ``rays`` (origins, directions, pixel ids)."""
    from pathtracerpython_tpu_torch.render.integrator import render_rays

    def loss(params, target):
        off, ang = to_pose(params)
        radiance = render_rays(*rays, move(scene, off, ang), cfg, key)
        return 0.5 * ((radiance - target) ** 2).mean()

    return loss


def run(scene_path: str | None = None, object_name: str | None = None,
        init_offset=(0.4, 0.0, 0.3), init_angle: float = 0.25,
        steps: int = 120, lr: float = 0.05, out_dir: str | None = None,
        seed: int = 0, spp: int = 1, bounces: int = 1,
        soft_beta: float = 0.03, soft_beta_start: float | None = None,
        beta_stages: int = 4, pyramid: bool = True, dof: str = "planar",
        desc=None, device="cuda", log=print) -> dict:
    """Fit the pose; ``steps`` Adam steps at each pyramid level, split over
    the beta stages. ``desc``: a ``SceneDescription`` to fit in place of
    ``scene_path``'s (a synthetic scene). Returns the result dict, which
    ``result.json`` in ``out_dir`` holds with the losses."""
    import numpy as np
    import torch

    from pathtracerpython_tpu_torch.apps.fit_albedo import (
        fit_scene_description,
    )
    from pathtracerpython_tpu_torch.diff import adam
    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.image import (
        radiance_to_image,
        save_png,
    )
    from pathtracerpython_tpu_torch.render.integrator import (
        render,
        render_rays,
    )
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene

    if out_dir is None:
        out_dir = os.path.join(tempfile.gettempdir(), "fit_pose")
    os.makedirs(out_dir, exist_ok=True)
    if desc is None:
        desc, scene_what = fit_scene_description(scene_path)
    else:
        scene_what = desc.path or "the given description"
    scene = pack_scene(desc, device=device)
    what, move, to_pose = pose_model(desc, object_name, dof)
    log(f"fit_pose: {what} in scene {scene_what} on {scene.device}")
    object_mode = object_name is not None
    betas = (beta_schedule(soft_beta, soft_beta_start, beta_stages)
             if object_mode else [soft_beta])

    def make_cfg(beta):
        # boundary gradients need the soft estimator; the light enters the
        # NEE smoothly and keeps the hard one
        return RenderConfig(mode="fast", n_samples=spp, n_bounces=bounces,
                            soft_vis_beta=beta if object_mode else 0.0)

    w, h = scene.meta.width, scene.meta.height
    key = (0, seed)  # jax.random.PRNGKey(seed)
    levels = (pyramid_levels(w, h, pyramid) if object_mode
              else [(w, h)])
    final_cfg = make_cfg(betas[-1])
    with torch.no_grad():
        save_png(radiance_to_image(render(scene, final_cfg, seed=seed), w,
                                   h), os.path.join(out_dir, "target.png"))

    params = torch.tensor(
        initial_params(object_name, dof, init_offset, init_angle),
        dtype=torch.float32, device=scene.device, requires_grad=True)
    losses, level_params = [], []
    for lw, lh in levels:
        origins, dirs = make_primary_rays(scene.eye, scene.ortho, lw, lh)
        rays = (origins, dirs,
                torch.arange(lw * lh, dtype=torch.int64, device=scene.device))
        # fresh moments for each level: they depend on the resolution
        opt = adam(lr)([params])
        level_params.append({"level": [lw, lh],
                             "start": params.detach().clone()})
        for beta, n_steps in zip(betas, stage_steps(steps, len(betas))):
            cfg = make_cfg(beta)
            with torch.no_grad():
                target = render_rays(*rays, scene, cfg, key)
            loss_fn = pose_loss(scene, move, to_pose, cfg, rays, key)
            for _ in range(n_steps):
                opt.zero_grad(set_to_none=True)
                loss = loss_fn(params, target)
                loss.backward()
                opt.step()
                # a host read here would wait for the step
                losses.append(loss.detach())
        level_params[-1]["end"] = params.detach().clone()

    with torch.no_grad():
        offset, angle = to_pose(params)
        fitted = render(move(scene, offset, angle), final_cfg, seed=seed)
    save_png(radiance_to_image(fitted, w, h),
             os.path.join(out_dir, "fitted.png"))
    losses = [float(x) for x in losses]
    level_params = [{"level": p["level"], "start": p["start"].tolist(),
                     "end": p["end"].tolist()} for p in level_params]
    offset = offset.detach().cpu().numpy()
    result = {
        "mode": what,
        "scene": scene_what,
        "device": (torch.cuda.get_device_name(scene.device)
                   if scene.device.type == "cuda" else "cpu"),
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "init_offset_norm": float(np.linalg.norm(np.asarray(init_offset))),
        "final_offset_norm": float(np.linalg.norm(offset)),
        "final_offset": offset.tolist(),
        "init_angle": float(init_angle) if object_mode else 0.0,
        "final_angle": (torch.atleast_1d(angle).detach().cpu().tolist()
                        if object_mode else 0.0),
        "betas": betas,
        "levels": levels,
        "level_params": level_params,
        "out_dir": out_dir,
    }
    log(json.dumps(result))
    with open(os.path.join(out_dir, "result.json"), "w") as f:
        json.dump({**result, "losses": losses}, f)
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--scene", default=None,
                   help="SDL scene, such as the reference program's "
                        "objs/cornellroom.sdl (default: the in-repo "
                        "stand-in)")
    p.add_argument("--object", default=None,
                   help="fit this object's pose instead of the light's "
                        "(runs the soft estimator for boundary gradients)")
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--init-angle", type=float, default=0.25,
                   help="initial yaw error in radians (object mode)")
    p.add_argument("--soft-beta", type=float, default=0.03,
                   help="final soft-visibility edge width (object mode)")
    p.add_argument("--soft-beta-start", type=float, default=None,
                   help="anneal start width (default 4x --soft-beta)")
    p.add_argument("--beta-stages", type=int, default=4,
                   help="annealing stages (1 = constant beta)")
    p.add_argument("--lr-object", type=float, default=OBJECT_LR,
                   help="learning rate in object mode (--lr covers light "
                        "mode)")
    p.add_argument("--no-pyramid", action="store_true",
                   help="no coarse-to-fine resolution pyramid (object "
                        "mode, scenes of 96 pixels and more)")
    p.add_argument("--dof", choices=("planar", "full"), default="planar",
                   help="object pose: planar (x, z, yaw) or full (xyz and "
                        "yaw, pitch, roll)")
    p.add_argument("--out", default=None,
                   help="output directory (default: fit_pose in the "
                        "temporary directory)")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    args = p.parse_args(argv)
    run(scene_path=args.scene, object_name=args.object, steps=args.steps,
        lr=args.lr_object if args.object else args.lr, out_dir=args.out,
        soft_beta=args.soft_beta, soft_beta_start=args.soft_beta_start,
        beta_stages=args.beta_stages, init_angle=args.init_angle,
        pyramid=not args.no_pyramid, dof=args.dof, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
