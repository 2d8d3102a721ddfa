"""Hold two checkouts of the port against each other on one card, in turns.

    python -m pathtracerpython_tpu_torch.compare_trees --other DIR \\
        [--out FILE] [--work DIR]

``DIR`` is the root of another checkout (a ``git archive`` of the parent
commit, say). The checkout that holds this file is "change", the other
"parent". Each runs in its own process, which imports that checkout's
``pathtracerpython_tpu_torch`` and builds its kernels, in the order parent,
change, change, parent, so that a drift of the card or the host over the
call falls on both sides. Each run:

- times the dense nearest kernel (K1, and K3's dense nearest under
  ``mt_impl="plucker"``) on the first and second bounce wavefronts of the
  Cornell stand-in (512x512, 4 spp) and the 300-box field (512x512,
  4 spp): the kernel's own launch with its pack (and boxes, where the
  checkout culls) built beforehand, CUDA events, 3 samples of the mean of
  20 launches after 3 warm-up launches;
- renders the Cornell cell (512x512, 4 spp, 4 bounces) and the boxfield300
  cell (512x512, 2 spp, 3 bounces), 3 NEE samples, seed 0, in both forms.

It prints, and writes to ``FILE`` as JSON, every run's times by wavefront
and the largest absolute difference of each render between every change
run and every parent run, and between the two runs of each checkout. Needs
a CUDA device; nothing here runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("parent", "change", "change", "parent")
FORMS = ("classic", "plucker")
NEE_SAMPLES = 3
# (name, (scene constructor, its keywords), pack keywords, spp, bounces)
CELLS = (("cornell", ("cornell_box_scene", {}), {"pad_to": 32}, 4, 4),
         ("boxfield300", ("box_field_scene", {"n_boxes": 300}), {}, 2, 3))
WAVEFRONT_SPP = 4


def _scene(synthetic, arrays, cell):
    _, (ctor, kw), pack_kw, _, _ = cell
    desc = getattr(synthetic, ctor)(width=512, height=512, **kw)
    return arrays.pack_scene(desc, **pack_kw)


def _wavefronts(port, scene):
    """(o3, d3 unit) of the first and second bounce wavefronts of the
    scene's batch_samples render at WAVEFRONT_SPP, as the render forms
    them."""
    import torch

    rng, camera = port["ops.rng"], port["ops.camera"]
    geometry, integrator = port["ops.geometry"], port["render.integrator"]
    cfg = port["render.config"].RenderConfig(
        n_samples=WAVEFRONT_SPP, n_bounces=2, n_light_samples=NEE_SAMPLES,
        batch_samples=True)
    bounds = (port["ops.sort"].scene_bounds(scene)
              if integrator._sort_enabled(scene, cfg) else None)
    w, h = scene.meta.width, scene.meta.height
    origins, dirs = camera.make_primary_rays(scene.eye, scene.ortho, w, h)
    pid = torch.arange(w * h, device=scene.device)
    counters = torch.cat([pid * WAVEFRONT_SPP + s
                          for s in range(WAVEFRONT_SPP)])
    state = integrator.init_rays(origins.T.repeat(1, WAVEFRONT_SPP),
                                 dirs.T.repeat(1, WAVEFRONT_SPP), counters)
    k0, k1 = rng.key_from_seed(0)
    out = []
    for b in range(2):
        _, o3, d3 = integrator.sort_and_park(state, bounds)
        out.append((o3.contiguous(), geometry.normalize3(d3).contiguous()))
        state = integrator.bounce_step(state, b, scene, cfg, k0, k1, bounds)
    return out


def _kernel(intersect, scene, form):
    """The checkout's dense nearest kernel as ``fn(o3, d3)``, its pack (and
    its boxes, where it culls) built beforehand."""
    tripack = intersect.scene_tripack(scene)
    plucker = form == "plucker"
    pack = intersect.scene_plucker_pack(scene) if plucker else tripack
    launch = intersect._launch_plucker if plucker else intersect._launch
    if hasattr(intersect, "nearest_cull_boxes"):
        cull = intersect.nearest_cull_boxes(tripack)
        return lambda o3, d3: launch(o3, d3, pack, cull)
    return lambda o3, d3: launch(o3, d3, pack)


def _ms(fn, reps: int = 20) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def worker(tree: str, out: str) -> None:
    """One run in one checkout: times to ``out`` + ".json", renders to
    ``out`` + "_<cell>_<form>.pt"."""
    sys.path[0] = tree   # not this file's directory, inside a package
    import importlib

    import torch

    import pathtracerpython_tpu_torch as pkg

    if not os.path.abspath(pkg.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {pkg.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the comparison runs on the card")
    port = {m: importlib.import_module(f"pathtracerpython_tpu_torch.{m}")
            for m in ("kernels.intersect", "ops.rng", "ops.camera",
                      "ops.geometry", "ops.sort", "render.config",
                      "render.integrator", "scene.arrays", "scene.synthetic")}
    intersect = port["kernels.intersect"]
    times = {}
    for cell in CELLS:
        scene = _scene(port["scene.synthetic"], port["scene.arrays"], cell)
        for b, (o3, d3) in enumerate(_wavefronts(port, scene), start=1):
            for form in FORMS:
                run = _kernel(intersect, scene, form)
                for _ in range(3):
                    run(o3, d3)
                times[f"{cell[0]} bounce {b} {form}"] = [
                    _ms(lambda: run(o3, d3)) for _ in range(3)]
        cfg_cls = port["render.config"].RenderConfig
        for form in FORMS:
            cfg = cfg_cls(mode="fast", n_samples=cell[3], n_bounces=cell[4],
                          n_light_samples=NEE_SAMPLES, batch_samples=True,
                          mt_impl=form)
            rad = port["render.integrator"].render(scene, cfg, seed=0)
            torch.save(rad.cpu(), f"{out}_{cell[0]}_{form}.pt")
    with open(out + ".json", "w") as f:
        json.dump(times, f)


def compare(other: str, work: str) -> dict:
    import torch

    os.makedirs(work, exist_ok=True)
    trees = {"parent": os.path.abspath(other), "change": THIS_ROOT}
    runs = []
    for k, side in enumerate(ORDER):
        out = os.path.join(work, f"run{k}_{side}")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", trees[side], "--out", out], check=True)
        with open(out + ".json") as f:
            runs.append((side, out, json.load(f)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    result = {"card": smi, "order": list(ORDER), "kernel_ms": {},
              "radiance_max_abs_diff": {}}
    for key in runs[0][2]:
        result["kernel_ms"][key] = {
            side: [t for s, _, r in runs if s == side for t in r[key]]
            for side in ("parent", "change")}
        result["kernel_ms"][key]["median"] = {
            side: statistics.median(v)
            for side, v in result["kernel_ms"][key].items()}
    for cell in CELLS:
        for form in FORMS:
            rad = [(side, torch.load(f"{out}_{cell[0]}_{form}.pt"))
                   for side, out, _ in runs]
            diffs = {}
            for i, (si, ri) in enumerate(rad):
                for j, (sj, rj) in enumerate(rad[i + 1:], start=i + 1):
                    diffs[f"run{i} {si} - run{j} {sj}"] = (
                        ri - rj).abs().max().item()
            result["radiance_max_abs_diff"][f"{cell[0]} {form}"] = diffs
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the other (parent) checkout")
    ap.add_argument("--out", help="write the result here as JSON")
    ap.add_argument("--work", default=os.path.join(THIS_ROOT, "build",
                                                   "compare_trees"),
                    help="directory for the runs' files")
    ap.add_argument("--worker", metavar="TREE",
                    help="internal: one run in checkout TREE")
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.out)
        return
    if not args.other:
        ap.error("--other is required")
    result = compare(args.other, args.work)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
