"""Inverse rendering demo: recover the Cornell walls' albedos from a
rendered target image (BASELINE.json config 3: "albedo + emission
gradients, inverse-rendering fit of wall colors"), the JAX package's
``apps/fit_albedo.py`` on PyTorch.

    python -m pathtracerpython_tpu_torch.apps.fit_albedo [--steps N]
        [--out DIR] [--scene SDL] [--device cuda|cpu]
        [--checkpoint-every K]

Runs on the card unless ``--device cpu`` is given; without a card the
default raises. The scene is ``--scene`` (the JAX app's Cornell room is
the reference program's ``objs/cornellroom.sdl``), else the in-repo
stand-in ``cornell_box_scene(128, 128)``, and the output says which. The
fit: ``mode="fast"``, 2 spp, 2
bounces, 3 NEE samples; params ``mat_rgb`` (from a quarter of the truth)
and ``light_color`` (from twice it), Adam with optax's defaults. With
``--checkpoint-every K`` the fit saves its whole state every K steps under
``OUT/ckpt`` and a rerun resumes from the latest (``diff.fit``), as the
JAX app does.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

STAND_IN_SIZE = 128
# the fit's render: the JAX app's 2 spp and 2 bounces, 3 NEE samples
SPP = 2
BOUNCES = 2
NEE_SAMPLES = 3


def fit_scene_description(scene_path: str | None):
    """(description, what): the SDL scene ``scene_path`` parsed, or the
    in-repo stand-in where it is None."""
    from pathtracerpython_tpu_torch.scene.sdl import load_sdl
    from pathtracerpython_tpu_torch.scene.synthetic import cornell_box_scene

    if scene_path is not None:
        return load_sdl(scene_path), scene_path
    return (cornell_box_scene(STAND_IN_SIZE, STAND_IN_SIZE),
            f"stand-in cornell_box_scene({STAND_IN_SIZE}, {STAND_IN_SIZE})"
            " (no --scene given)")


def load_fit_scene(scene_path: str | None, device):
    """(scene, what): the SDL scene ``scene_path``, or the in-repo
    stand-in where it is None, on ``device``."""
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene

    desc, what = fit_scene_description(scene_path)
    return pack_scene(desc, device=device), what


def run(scene_path: str | None = None, steps: int = 60, lr: float = 0.05,
        out_dir: str | None = None, fit_emission: bool = True,
        seed: int = 0, spp: int = SPP, bounces: int = BOUNCES,
        checkpoint_every: int = 0, device="cuda", log=print) -> dict:
    import numpy as np
    import torch

    from pathtracerpython_tpu_torch.diff import adam, apply_params, fit
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.image import (
        radiance_to_image,
        save_png,
    )
    from pathtracerpython_tpu_torch.render.integrator import render

    if out_dir is None:
        out_dir = os.path.join(tempfile.gettempdir(), "fit_albedo")
    os.makedirs(out_dir, exist_ok=True)
    scene, what = load_fit_scene(scene_path, device)
    log(f"fit_albedo: scene {what} on {scene.device}")
    cfg = RenderConfig(mode="fast", n_samples=spp, n_bounces=bounces,
                       n_light_samples=NEE_SAMPLES)
    w, h = scene.meta.width, scene.meta.height

    with torch.no_grad():
        target = render(scene, cfg, seed=seed)
    save_png(radiance_to_image(target, w, h),
             os.path.join(out_dir, "target.png"))

    params = {"mat_rgb": scene.mat_rgb * 0.25}
    if fit_emission:
        params["light_color"] = scene.light_color * 2.0
    # a resumed fit continues from the saved params, optimizer state and
    # RNG position, so a restart gives the uninterrupted fit's steps
    params, losses = fit(
        params, adam(lr), scene, cfg, target, steps=steps, seed=seed,
        checkpoint_dir=(os.path.join(out_dir, "ckpt")
                        if checkpoint_every > 0 else None),
        checkpoint_every=checkpoint_every)

    with torch.no_grad():
        fitted = render(apply_params(scene, params), cfg, seed=seed)
    save_png(radiance_to_image(fitted, w, h),
             os.path.join(out_dir, "fitted.png"))

    k = scene.meta.n_objects
    err = float(np.abs(params["mat_rgb"].cpu().numpy()[:k]
                       - scene.mat_rgb.cpu().numpy()[:k]).max())
    result = {
        "scene": what,
        "device": (torch.cuda.get_device_name(scene.device)
                   if scene.device.type == "cuda" else "cpu"),
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "max_albedo_err": err,
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
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--out", default=None,
                   help="output directory (default: fit_albedo in the "
                        "temporary directory)")
    p.add_argument("--no-emission", action="store_true")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save the fit every K steps under OUT/ckpt and "
                        "resume from the latest there (0: never)")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    args = p.parse_args(argv)
    run(scene_path=args.scene, steps=args.steps, lr=args.lr,
        out_dir=args.out, fit_emission=not args.no_emission,
        checkpoint_every=args.checkpoint_every, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
