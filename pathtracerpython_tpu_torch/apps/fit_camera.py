"""Inverse rendering demo: recover the camera's eye from a target image, the
JAX package's ``apps/fit_camera.py`` on PyTorch.

    python -m pathtracerpython_tpu_torch.apps.fit_camera [--steps N]
        [--lr LR] [--out DIR] [--scene SDL] [--device cuda|cpu]

The camera is an eye point and an ortho window on z = 0. Primary rays are
made inside the loss (``diff.camera_pixel_loss``), so the eye is a
parameter like any other: its gradient flows through the ray origins and
directions into the hit re-solve (K1's backward), the shading points and
the NEE geometry (K2's backward). The hard estimator; ``diff.fit`` with
Adam from an eye offset by (0.15, -0.1, 0.2), 2 spp, 2 bounces, 3 NEE
samples.

Runs on the card unless ``--device cpu`` is given; without a card the
default raises. The scene is ``--scene``, else the in-repo stand-in
``cornell_box_scene(128, 128)`` (``apps/fit_albedo.py:load_fit_scene``),
and the output says which.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

SPP = 2
BOUNCES = 2
OFFSET = (0.15, -0.1, 0.2)


def run(scene_path: str | None = None, steps: int = 80, lr: float = 0.02,
        offset: tuple = OFFSET, out_dir: str | None = None, seed: int = 0,
        spp: int = SPP, bounces: int = BOUNCES, device="cuda",
        log=print) -> dict:
    import numpy as np
    import torch

    from pathtracerpython_tpu_torch.apps.fit_albedo import load_fit_scene
    from pathtracerpython_tpu_torch.diff import adam, fit
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.image import (
        radiance_to_image,
        save_png,
    )
    from pathtracerpython_tpu_torch.render.integrator import render

    if out_dir is None:
        out_dir = os.path.join(tempfile.gettempdir(), "fit_camera")
    os.makedirs(out_dir, exist_ok=True)
    scene, what = load_fit_scene(scene_path, device)
    log(f"fit_camera: scene {what} on {scene.device}")
    cfg = RenderConfig(mode="fast", n_samples=spp, n_bounces=bounces)

    with torch.no_grad():
        target = render(scene, cfg, seed=seed)
    save_png(radiance_to_image(target, scene.meta.width, scene.meta.height),
             os.path.join(out_dir, "target.png"))

    true_eye = scene.eye.cpu().numpy()
    params = {"eye": scene.eye + scene.eye.new_tensor(offset)}
    err0 = float(np.abs(params["eye"].cpu().numpy() - true_eye).max())
    params, losses = fit(params, adam(lr), scene, cfg, target, steps=steps,
                         seed=seed)

    eye = params["eye"].cpu().numpy()
    result = {
        "scene": what,
        "device": (torch.cuda.get_device_name(scene.device)
                   if scene.device.type == "cuda" else "cpu"),
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "eye_err_initial": err0,
        "eye_err_final": float(np.abs(eye - true_eye).max()),
        "eye_fitted": eye.tolist(),
        "eye_true": true_eye.tolist(),
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
    p.add_argument("--steps", type=int, default=80)
    p.add_argument("--lr", type=float, default=0.02)
    p.add_argument("--out", default=None,
                   help="output directory (default: fit_camera in the "
                        "temporary directory)")
    p.add_argument("--device", default="cuda",
                   help="torch device; cpu runs the kernels' plain versions")
    args = p.parse_args(argv)
    run(scene_path=args.scene, steps=args.steps, lr=args.lr,
        out_dir=args.out, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
