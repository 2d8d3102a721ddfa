"""CLI: render an SDL scene to a PNG, as the JAX package's ``cli/main.py``.

    python -m pathtracerpython_tpu_torch scene.sdl --out out.png -r 64 -b 2
        [--mode reference] [--metrics] [--ckpt-dir D] [--platform cpu]

Every flag of the JAX CLI parses. Flag-compatible with the reference's
argparse setup (its ``main.py:125-139``): the positional ``scene``,
``--out``, ``-r`` rays per pixel, ``-b`` bounces and the ``--show-*`` debug
views (offline PNGs beside ``--out``). The render runs on the card; with
``--platform cpu`` on the CPU, where the kernels' plain versions run.
Without a CUDA device and without ``--platform cpu`` the CLI exits with
status 2 and says why: it never falls back to the CPU (the JAX CLI does).

Flags that have no meaning here are accepted and noted in the log:
``--backend`` (the device decides: CUDA kernels on the card, their plain
versions on the CPU; reference mode always runs the plain reference
sweeps) and ``--no-compile-cache`` (nothing is compiled through XLA).
``--mt-impl`` sets ``RenderConfig.mt_impl``.

Sharded renders run under torchrun, one process a rank:

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        -m pathtracerpython_tpu_torch scene.sdl --out out.png --dp 2

The world is dp x geom ranks (``--dp 0`` takes world / geom); ``--geom``
above 1 splits the triangles over a geometry ring
(``parallel/ring.py``), and the padded triangle count must divide by it.
Ranks that share a card talk through gloo (``parallel/multihost.py``).
Every rank renders its slice and holds the whole image; rank 0 alone
prints, writes the PNG and the checkpoints. Outside torchrun, ``--dp`` or
``--geom`` above 1 exits with status 2 and prints the line to launch.

Renders of ``-r >= 64`` are chunked at 16 spp unless ``--chunk-spp`` says
otherwise, as in the JAX CLI, so that the two CLIs render the same image;
chunking changes the sample-to-RNG mapping (ROADMAP.md queue C), and the
log says which chunk size was chosen.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# The JAX CLI's auto-chunk rule (its cli/main.py:227-228)
AUTO_CHUNK_MIN_SPP = 64
AUTO_CHUNK_SPP = 16
EXIT_REFUSED = 2


def setup(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(
        prog="ptpt-torch",
        description="differentiable path tracer on PyTorch and CUDA",
    )
    # reference-compatible flags (main.py:125-139)
    p.add_argument("scene", help="SDL scene file")
    p.add_argument("--out", default="out.png", help="output image path")
    p.add_argument("-r", "--rays-per-pixel", type=int, default=None,
                   help="samples per pixel (reference -r; default 1, or the "
                        "SDL's npaths under --honor-sdl)")
    p.add_argument("-b", "--bounces", type=int, default=1,
                   help="path bounces (reference -b)")
    p.add_argument("--honor-sdl", action="store_true",
                   help="honor the SDL fields the reference parses but "
                        "ignores: npaths (spp), seed, tonemapping (gamma), "
                        "background (paid on miss). Explicit -r/--seed "
                        "flags still win")
    p.add_argument("--show-img", action="store_true",
                   help="open the rendered image (needs PIL)")
    p.add_argument("--show-scene", action="store_true",
                   help="write a 3-D wireframe debug view (needs "
                        "matplotlib)")
    p.add_argument("--show-normals", action="store_true",
                   help="include normals in the debug view")
    p.add_argument("--show-screen", action="store_true",
                   help="include colored screen points in the debug view")
    p.add_argument("--show-inter", action="store_true",
                   help="include first-hit points in the debug view")
    # extensions of the JAX CLI
    p.add_argument("--mode", choices=("fast", "reference"), default="fast",
                   help="estimator: fast (default) or reference-parity")
    p.add_argument("--backend", choices=("xla", "pallas", "auto"),
                   default="auto",
                   help="accepted for the JAX CLI's sake and ignored: the "
                        "device decides (CUDA kernels on the card, their "
                        "plain versions on the CPU)")
    p.add_argument("--light-samples", type=int, default=3,
                   help="NEE samples per shading point (reference "
                        "hardcodes 3)")
    p.add_argument("--seed", type=int, default=None,
                   help="RNG seed (default 0, or the SDL's seed under "
                        "--honor-sdl)")
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel mesh axis size (0 = world / geom; "
                        "above 1 runs under torchrun, one process a rank)")
    p.add_argument("--geom", type=int, default=1,
                   help="geometry-ring mesh axis size (triangles sharded "
                        "over it; above 1 runs under torchrun)")
    p.add_argument("--normalization", choices=("minmax", "clip"),
                   default="minmax",
                   help="minmax reproduces the reference's auto-normalize")
    p.add_argument("--pad-to", type=int, default=128,
                   help="triangle buffer padding multiple")
    p.add_argument("--morton", action="store_true",
                   help="spatially sort triangles (tighter block boxes -> "
                        "faster large scenes; fast mode only)")
    p.add_argument("--tri-order", choices=("morton", "median"),
                   default=None,
                   help="spatial ordering flavor when sorting is active: "
                        "morton z-order (default) or median-split BVH "
                        "leaves")
    p.add_argument("--accel",
                   choices=("auto", "sparse", "walker", "hybrid", "none"),
                   default="auto",
                   help="acceleration hierarchy for large scenes "
                        "(bit-identical either way): auto = hybrid from "
                        "4,096 padded triangles; sparse / walker force one "
                        "hierarchy for both sweeps; none = dense sweeps")
    p.add_argument("--sort-rays", choices=("auto", "on", "off"),
                   default="auto",
                   help="per-bounce wavefront ray sorting (bit-identical)")
    p.add_argument("--sort-nee", choices=("auto", "on", "off"),
                   default="auto",
                   help="shadow-lane ordering + relevance parking before "
                        "the sparse NEE any-hit (bit-identical; auto = on "
                        "where a hierarchy runs)")
    p.add_argument("--nee-cache", choices=("auto", "on", "off"),
                   default="auto",
                   help="occluder-cluster caching on the sparse NEE any-hit "
                        "(bit-identical; auto = off)")
    p.add_argument("--nee-hint", choices=("auto", "on", "off"),
                   default="auto",
                   help="occlusion-hint block segregation on the sorted NEE "
                        "sweep (bit-identical; auto = off)")
    p.add_argument("--mt-impl", choices=("classic", "plucker"),
                   default="classic",
                   help="in-triangle test of the sweeps that have both "
                        "forms: classic Moller-Trumbore or the Plucker side "
                        "tests (RenderConfig.mt_impl)")
    p.add_argument("--platform", choices=("default", "cpu", "cuda"),
                   default="default",
                   help="where to render: default and cuda the card (exit "
                        "status 2 without one), cpu the CPU")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="accepted for the JAX CLI's sake and ignored: "
                        "nothing is compiled through XLA")
    p.add_argument("--metrics", action="store_true",
                   help="print a JSON metrics summary (timings, rays/s)")
    p.add_argument("--chunk-spp", type=int, default=-1,
                   help="render in sample chunks of this size, printing a "
                        "progress line per chunk (index, elapsed, rays/s). "
                        "-1 (default) auto-chunks at 16 spp when -r >= 64, "
                        "as the JAX CLI does; 0 disables chunking. NOTE: "
                        "chunking changes the sample->RNG mapping, so the "
                        "image differs from the unchunked render by Monte "
                        "Carlo noise only (utils/checkpoint.py)")
    p.add_argument("--ckpt-dir", default=None,
                   help="checkpoint each chunk here and resume from the "
                        "latest (implies chunking)")
    p.add_argument("--quiet", action="store_true")
    return p.parse_args(argv)


def _refuse(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return EXIT_REFUSED


def main(argv=None) -> int:
    args = setup(argv)
    log = (lambda *a: None) if args.quiet else print

    import torch

    from pathtracerpython_tpu_torch.parallel import multihost

    if args.platform != "cpu" and not torch.cuda.is_available():
        return _refuse(
            "no CUDA device: this CLI renders on the card; pass --platform "
            "cpu to render on the CPU (it does not fall back by itself)")
    sharded = args.dp > 1 or args.geom > 1
    if sharded and (os.environ.get("WORLD_SIZE") in (None, "", "1")):
        n = max(args.dp, 1) * args.geom
        return _refuse(
            f"--dp {args.dp} --geom {args.geom} needs {n} ranks: launch "
            f"with torchrun, one process a rank:\n  "
            + multihost.launch_hint(n, [
                "-m", "pathtracerpython_tpu_torch",
                *(argv if argv is not None else sys.argv[1:])]))
    try:
        return _main(args, log)
    finally:
        multihost.shutdown()


def _main(args, log) -> int:
    import torch

    from pathtracerpython_tpu_torch.parallel import (
        make_mesh,
        multihost,
        render_sharded,
    )

    platform = "cpu" if args.platform == "cpu" else "auto"
    multihost.initialize(platform=platform, log=log)
    if not multihost.is_primary():
        log = lambda *a: None  # noqa: E731 (rank 0 alone prints)
    mesh = None
    if multihost.world_size() > 1 or args.dp > 0:
        try:
            mesh = make_mesh(dp=args.dp if args.dp > 0 else None,
                             geom=args.geom)
        except ValueError as e:
            return _refuse(str(e))
        log(f"mesh: {mesh.shape} over {multihost.world_size()} rank(s), "
            f"transport {multihost.describe_transport()}")
    device = (str(mesh.device) if mesh is not None
              else ("cpu" if args.platform == "cpu" else "cuda"))

    from pathtracerpython_tpu_torch.kernels.sparse import SPARSE_MIN_TRIS
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.image import (
        radiance_to_image,
        save_png,
    )
    from pathtracerpython_tpu_torch.render.integrator import render
    from pathtracerpython_tpu_torch.scene.arrays import load_scene
    from pathtracerpython_tpu_torch.utils import MetricsLogger
    from pathtracerpython_tpu_torch.utils.checkpoint import render_progressive

    if args.backend != "auto":
        log(f"note: --backend {args.backend} is ignored: the device decides "
            f"({device})")
    if args.no_compile_cache:
        log("note: --no-compile-cache is ignored: nothing is compiled "
            "through XLA")
    if args.morton and args.mode == "reference":
        log("note: --morton changes tie-break order; ignored in reference "
            "mode")

    scene = load_scene(args.scene, pad_to=args.pad_to, device=device)
    # the cluster hierarchies key off spatial locality: morton order for
    # large fast-mode scenes unless asked otherwise
    use_morton = args.mode != "reference" and (
        args.morton or (args.accel != "none"
                        and scene.num_padded_triangles >= SPARSE_MIN_TRIS))
    if use_morton:
        scene = load_scene(args.scene, pad_to=args.pad_to,
                           tri_order=args.tri_order or "morton",
                           device=device)
    # explicit CLI flags > SDL values (--honor-sdl) > reference defaults
    meta = scene.meta
    n_samples = args.rays_per_pixel
    if n_samples is None:
        n_samples = meta.npaths if args.honor_sdl and meta.npaths else 1
    seed = args.seed
    if seed is None:
        seed = meta.seed if args.honor_sdl and meta.seed is not None else 0
    tonemapping = meta.tonemapping if args.honor_sdl else None

    cfg = RenderConfig(
        mode=args.mode,
        n_samples=n_samples,
        n_bounces=args.bounces,
        n_light_samples=args.light_samples,
        use_background=args.honor_sdl,
        accel=args.accel,
        sort_rays=args.sort_rays,
        sort_nee=args.sort_nee,
        nee_cache=args.nee_cache,
        nee_hint=args.nee_hint,
        mt_impl=args.mt_impl,
    )
    log(f"scene: {args.scene} ({meta.n_triangles} triangles, "
        f"{meta.width}x{meta.height}) on {scene.device}")
    log(f"config: {cfg}")

    chunk_spp = args.chunk_spp
    if chunk_spp < 0:
        chunk_spp = (AUTO_CHUNK_SPP if cfg.n_samples >= AUTO_CHUNK_MIN_SPP
                     else 0)
        if chunk_spp:
            log(f"note: auto-chunked at {chunk_spp} spp (-r >= "
                f"{AUTO_CHUNK_MIN_SPP}); chunking changes the sample->RNG "
                "mapping (--chunk-spp 0 renders unchunked)")
    if args.ckpt_dir is not None and chunk_spp == 0:
        chunk_spp = max(1, min(AUTO_CHUNK_SPP, cfg.n_samples))
    if chunk_spp:
        log(f"chunks: {chunk_spp} spp each")
    rays_per_spp = (meta.width * meta.height * cfg.n_bounces
                    * (1 + cfg.n_light_samples))

    geom_axis = "geom" if args.geom > 1 else None

    def render_once(sc, c, seed: int):
        # chunked and unchunked renders share one dispatch
        if mesh is None:
            return render(sc, c, seed=seed)
        return render_sharded(sc, c, mesh, seed=seed, geom_axis=geom_axis)

    def render_chunked(seed: int, checkpoint=True, progress=True):
        def prog(done, total, spp_done, dt):
            log(f"chunk {done}/{total}: {spp_done} spp total, {dt:.2f}s, "
                f"{rays_per_spp * chunk_spp / dt / 1e6:.1f} Mrays/s")

        return render_progressive(
            scene, cfg, cfg.n_samples, chunk_spp,
            checkpoint_dir=args.ckpt_dir if checkpoint else None,
            seed=seed, log=log, progress=prog if progress else None,
            renderer=render_once,
        )

    def render_full(seed: int, checkpoint=True, progress=True):
        if chunk_spp > 0:
            return render_chunked(seed, checkpoint, progress)
        return render_once(scene, cfg, seed)

    metrics = MetricsLogger()
    t0 = time.perf_counter()
    with torch.no_grad():
        with metrics.timed("render", device=scene.device) as box:
            radiance = render_full(seed)
            box["out"] = radiance
    log(f"rendered in {time.perf_counter() - t0:.2f}s")
    # every wavefront lane-bounce: dead lanes are masked, not compacted
    metrics.count("rays_attempted",
                  meta.width * meta.height * cfg.n_samples * cfg.n_bounces
                  * (1 + cfg.n_light_samples))
    if args.metrics:
        # every rank renders (the ranks render together); rank 0 prints
        # a second render with another seed and the same plan (chunked
        # stays chunked), without checkpoints and progress lines: the
        # first pays the kernels' build and the caches' fill
        with torch.no_grad():
            with metrics.timed("render_steady", device=scene.device) as box:
                box["out"] = render_full(seed + 1, checkpoint=False,
                                         progress=False)
        if multihost.is_primary():
            print(json.dumps({
                **metrics.summary(),
                "device": str(scene.device),
                "ranks": multihost.world_size(),
                "rays_attempted_per_s_incl_compile": metrics.rate(
                    "rays_attempted", "render"),
                "rays_attempted_per_s_steady": metrics.rate(
                    "rays_attempted", "render_steady"),
            }), flush=True)
    if not multihost.is_primary():
        return 0

    image = radiance_to_image(radiance, meta.width, meta.height,
                              normalization=args.normalization,
                              tonemapping=tonemapping)
    save_png(image, args.out)
    log(f"wrote {args.out}")

    if (args.show_scene or args.show_normals or args.show_screen
            or args.show_inter):
        from pathtracerpython_tpu_torch.viz import plot_scene

        intersections = None
        if args.show_inter:
            from pathtracerpython_tpu_torch.ops.camera import (
                make_primary_rays,
            )
            from pathtracerpython_tpu_torch.ops.geometry import (
                nearest_hit_cm,
            )

            # the render's own sweep: K1 or a hierarchy on the card in
            # fast mode, the reference sweep in reference mode
            o, d = make_primary_rays(scene.eye, scene.ortho, meta.width,
                                     meta.height)
            hit = nearest_hit_cm(o.T, d.T, scene, accel=cfg.accel,
                                 mt_impl=cfg.mt_impl, mode=cfg.mode)
            intersections = hit.point3.T[hit.hit]
        debug_path = os.path.splitext(args.out)[0] + "_scene.png"
        plot_scene(
            scene, debug_path,
            show_normals=args.show_normals,
            show_screen=args.show_screen,
            screen_colors=radiance if args.show_screen else None,
            intersections=intersections,
        )
        log(f"wrote {debug_path}")

    if args.show_img:
        try:
            from PIL import Image
        except ImportError:
            return _refuse("--show-img needs PIL, which is not installed; "
                           f"the image is at {args.out}")
        Image.fromarray(image).show()
    return 0


if __name__ == "__main__":
    sys.exit(main())
