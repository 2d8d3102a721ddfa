"""Entry points in the style of the JAX package's ``__graft_entry__.py``: a
single-card forward step with example arguments, and a dry run of every
sharded shape over n ranks.

    python -m pathtracerpython_tpu_torch.entry            # entry() once
    python -m pathtracerpython_tpu_torch.entry --dryrun 2 [--platform cpu]

- ``entry()`` returns ``(fn, example_args)``: ``fn`` is the forward
  ``render_rays`` of the fast estimator (4 bounces, 1 spp) on the card, the
  flagship single-card path, and the arguments are the Cornell box's
  primary rays, pixel ids and a key. The scene is the reference program's
  ``objs/cornellroom.sdl`` when its path is passed (``sdl=``) or named by
  the environment variable ``PTPT_CORNELL_SDL``, else the in-repo stand-in
  ``synthetic.cornell_box_scene``; it says which.
- ``dryrun_multichip(n)`` runs the JAX dry run's four shapes over n ranks on
  tiny shapes, spawning the ranks itself (gloo, a ``file://`` rendezvous)
  when called outside a process group:
  1. the fast training step (``mat_rgb``, ``light_color``, ``eye``) on
     (dp = n/2, geom = 2): rays data-parallel, triangles on the ring,
     gradients summed over the ray axes;
  2. a reference-mode render on (dp = n/4, geom = 4), where n allows;
  3. the soft estimator's render on dp = n;
  4. the bounce pipeline on pp = 2 (dp = n/2), bit-equal to the
     single-rank render.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

SDL_ENV = "PTPT_CORNELL_SDL"
# the dry run's film plane, as the JAX dry run shrinks its scene to 8x8
DRYRUN_SIZE = 8


def _cornell(sdl: str | None, width: int | None, device, log=print):
    """The Cornell box: ``sdl`` (or the file ``$PTPT_CORNELL_SDL`` names)
    when given and present, else the in-repo stand-in."""
    from pathtracerpython_tpu_torch.scene.arrays import load_scene, pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import cornell_box_scene

    sdl = sdl or os.environ.get(SDL_ENV)
    if sdl and os.path.exists(sdl):
        scene = load_scene(sdl, pad_to=32, device=device)
        if width is not None:
            import dataclasses

            scene = dataclasses.replace(scene, meta=dataclasses.replace(
                scene.meta, width=width, height=width))
        log(f"entry: scene {sdl}")
        return scene
    size = width or 40
    log(f"entry: no Cornell SDL found (sdl= or ${SDL_ENV}); using the "
        f"in-repo stand-in cornell_box_scene({size}, {size})")
    return pack_scene(cornell_box_scene(size, size), pad_to=32, device=device)


def entry(sdl: str | None = None, device="cuda", log=print):
    """(fn, example_args): ``fn(scene, origins, directions, pixel_ids, key)``
    is the forward fast-mode render of the primary rays (4 bounces, 1 spp,
    3 NEE samples), radiance [N, 3]; the arguments are the Cornell box's
    own, on ``device``."""
    import torch

    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render_rays

    scene = _cornell(sdl, None, device, log)
    cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=4)

    def forward(scene_tensors, origins, directions, pixel_ids, key):
        return render_rays(origins, directions, pixel_ids, scene_tensors,
                           cfg, key)

    w, h = scene.meta.width, scene.meta.height
    origins, dirs = make_primary_rays(scene.eye, scene.ortho, w, h)
    pixel_ids = torch.arange(w * h, dtype=torch.int64, device=scene.device)
    return forward, (scene, origins, dirs, pixel_ids, (0, 0))


def dryrun_multichip(n_devices: int, platform: str = "auto",
                     sdl: str | None = None, log=print) -> None:
    """The four sharded shapes over ``n_devices`` ranks (see the module's
    docstring); raises if a shape fails. Inside an initialised process
    group of that size it runs on this rank; outside one it starts the
    ranks as processes of this module and waits for them all. The ranks
    run on the card, on the CPU only with ``platform="cpu"``: without a
    card it raises ``RuntimeError`` otherwise."""
    import torch.distributed as dist

    from pathtracerpython_tpu_torch.parallel import multihost

    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) in a world of "
                             f"{dist.get_world_size()} ranks")
        _dryrun_rank(n_devices, sdl, log, multihost.device())
        return
    if n_devices == 1:
        _dryrun_rank(1, sdl, log, multihost.default_device(0, 1, platform))
        return
    multihost.default_device(0, 1, platform)  # no card: raise here, once
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "pathtracerpython_tpu_torch.entry",
             "--dryrun", str(n_devices), "--rank", str(r), "--init", init,
             "--platform", platform, *(["--sdl", sdl] if sdl else [])],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(n_devices)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=900)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for line in outs[0].splitlines():
        log(line)
    failed = [(r, p.returncode) for r, p in enumerate(procs)
              if p.returncode != 0]
    if failed:
        raise RuntimeError(f"dryrun_multichip({n_devices}): ranks {failed} "
                           "failed:\n" + "\n".join(
                               outs[r][-3000:] for r, _ in failed))


def _dryrun_rank(n: int, sdl: str | None, log, device) -> None:
    """One rank of the dry run on ``device``, in an initialised group of
    ``n`` ranks (or alone, n = 1)."""
    import torch

    from pathtracerpython_tpu_torch.diff import adam, make_train_step
    from pathtracerpython_tpu_torch.parallel import (
        make_mesh,
        multihost,
        render_pipelined,
        render_sharded,
    )
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render

    say = log if multihost.is_primary() else (lambda *a: None)
    scene = _cornell(sdl, DRYRUN_SIZE, device, say)

    # shape 1: the fast training step on dp x geom = 2
    geom = 2 if n % 2 == 0 else 1
    mesh = make_mesh(dp=n // geom, geom=geom, device=device)
    cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=2,
                       n_light_samples=1)
    with torch.no_grad():
        target = render(scene, cfg, seed=0)
    params = {"mat_rgb": scene.mat_rgb * 0.5,
              "light_color": scene.light_color * 1.5,
              "eye": scene.eye + 0.05}
    params = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    opt = adam(1e-2)(list(params.values()))
    step = make_train_step(opt, scene, cfg, target, mesh=mesh,
                           geom_axis="geom" if geom > 1 else None)
    loss = float(step(params, (0, 1)))
    if not torch.isfinite(torch.tensor(loss)):
        raise RuntimeError(f"dryrun_multichip: loss {loss}")
    say(f"dryrun_multichip: mesh={mesh.shape} loss={loss:.6f}")

    # shape 2: a reference-mode render on a geom = 4 ring
    if n % 4 == 0:
        mesh4 = make_mesh(dp=n // 4, geom=4, device=device)
        cfg_ref = RenderConfig(mode="reference", n_samples=1, n_bounces=2,
                               n_light_samples=1)
        with torch.no_grad():
            rad = render_sharded(scene, cfg_ref, mesh4, seed=0,
                                 geom_axis="geom")
        if not bool(torch.isfinite(rad).all()):
            raise RuntimeError("dryrun_multichip: reference render not "
                               "finite")
        say(f"dryrun_multichip: mesh={mesh4.shape} reference-mode render ok "
            f"(mean={float(rad.mean()):.6f})")

    # shape 3: the soft estimator, pure dp
    mesh_dp = make_mesh(dp=n, geom=1, device=device)
    cfg_f = RenderConfig(mode="fast", n_samples=1, n_bounces=2,
                         n_light_samples=1, soft_vis_beta=0.05)
    with torch.no_grad():
        rad_f = render_sharded(scene, cfg_f, mesh_dp, seed=0)
    if not bool(torch.isfinite(rad_f).all()):
        raise RuntimeError("dryrun_multichip: soft render not finite")
    say(f"dryrun_multichip: mesh={mesh_dp.shape} soft-estimator render ok "
        f"(mean={float(rad_f.mean()):.6f})")

    # shape 4: the bounce pipeline, bit-equal to the single-rank render
    if n % 2 == 0:
        mesh_pp = make_mesh(pp=2, dp=n // 2, device=device)
        cfg_pp = RenderConfig(mode="fast", n_samples=1, n_bounces=2,
                              n_light_samples=1)
        with torch.no_grad():
            rad_pp = render_pipelined(scene, cfg_pp, mesh_pp, seed=0)
            single = render(scene, cfg_pp, seed=0)
        if not torch.equal(rad_pp, single):
            raise RuntimeError("dryrun_multichip: pp render != single")
        say(f"dryrun_multichip: mesh={mesh_pp.shape} pp-pipeline render "
            f"bit-matches single (mean={float(rad_pp.mean()):.6f})")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--dryrun", type=int, default=0,
                   help="run dryrun_multichip over this many ranks")
    p.add_argument("--rank", type=int, default=None,
                   help="(set by the dry run for the ranks it starts)")
    p.add_argument("--init", default=None,
                   help="(the ranks' rendezvous, set by the dry run)")
    p.add_argument("--platform", choices=("auto", "cuda", "cpu"),
                   default="auto")
    p.add_argument("--sdl", default=None)
    args = p.parse_args(argv)
    if not args.dryrun:
        import torch

        fn, example = entry(args.sdl, "cpu" if args.platform == "cpu"
                            else "cuda")
        with torch.no_grad():
            rad = fn(*example)
        print(f"entry: radiance {tuple(rad.shape)} on {rad.device}, mean "
              f"{float(rad.mean()):.6f}")
        return 0
    if args.rank is None:
        dryrun_multichip(args.dryrun, args.platform, args.sdl)
        return 0
    from pathtracerpython_tpu_torch.parallel import multihost

    multihost.initialize(init_method=args.init, world_size=args.dryrun,
                         rank=args.rank, platform=args.platform)
    try:
        _dryrun_rank(args.dryrun, args.sdl, print, multihost.device())
        multihost.sync()
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
