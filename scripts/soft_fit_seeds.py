"""Run the object pose fit (``apps/fit_pose.py --object cube``) on several
seeds and learning rates, to see how reliably it recovers the pose.

    python scripts/soft_fit_seeds.py                      # the port, on the card
    python scripts/soft_fit_seeds.py --lrs 0.03 --seeds 0 1
    JAX_PLATFORMS=cpu python scripts/soft_fit_seeds.py --jax --lrs 0.03

Each run is ``fit_pose.run(object_name="cube", lr=lr, seed=seed)`` with the
app's other defaults: the stand-in Cornell box at 128^2, the first cube's
planar pose from an offset of (0.4, 0, 0.3) and a yaw of 0.25 rad, 120 steps
a level over the pyramid 40^2 -> 128^2, 4 beta stages 0.12 -> 0.03, 1 spp,
1 bounce. The soft backward scatters with float atomics on the card, so
two runs of one seed can follow different paths. ``--jax`` runs the JAX
package's app instead, jitted on the CPU, on the same stand-in (about 400 s
a fit). Prints one JSON line a run and a summary line per lr (the largest
final offset norm and yaw error over its runs).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pathtracerpython_tpu_torch.apps import fit_pose  # noqa: E402
from pathtracerpython_tpu_torch.scene.synthetic import (  # noqa: E402
    cornell_box_scene,
)


def jax_runner():
    """``run(lr, seed, out_dir)`` of the JAX package's app on the CPU, on
    the stand-in packed by the JAX package, its object found by the port's
    ``find_object_index`` (the JAX app looks the name up in an SDL file)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_parity import to_jax_desc

    from pathtracerpython_tpu.apps import fit_pose as jax_fit_pose
    from pathtracerpython_tpu.scene.arrays import pack_scene

    desc = cornell_box_scene(128, 128)
    scene = pack_scene(to_jax_desc(desc))
    jax_fit_pose.find_object_index = (
        lambda _, name: fit_pose.find_object_index(desc, name))

    def run(lr, seed, out_dir):
        return jax_fit_pose.run(object_name="cube", lr=lr, seed=seed,
                                out_dir=out_dir, scene_arrays=scene,
                                log=lambda *_: None)

    return run


def port_run(lr, seed, out_dir):
    return fit_pose.run(object_name="cube", lr=lr, seed=seed,
                        out_dir=out_dir, log=lambda *_: None)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--lrs", type=float, nargs="+", default=[0.03, 0.05])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    p.add_argument("--jax", action="store_true",
                   help="the JAX package's app, on the CPU")
    args = p.parse_args(argv)
    run = jax_runner() if args.jax else port_run

    for lr in args.lrs:
        runs = []
        for seed in args.seeds:
            with tempfile.TemporaryDirectory() as out:
                t0 = time.perf_counter()
                r = run(lr, seed, out)
                wall = time.perf_counter() - t0
            result = {"package": "jax" if args.jax else "port", "lr": lr,
                      "seed": seed,
                      "final_offset_norm": r["final_offset_norm"],
                      "final_yaw_error": abs(r["final_angle"][0]),
                      "loss_last": r["loss_last"], "wall_s": wall}
            runs.append(result)
            print(json.dumps(result), flush=True)
        print(json.dumps({
            "lr": lr, "runs": len(runs),
            "max_offset_norm": max(r["final_offset_norm"] for r in runs),
            "max_yaw_error": max(r["final_yaw_error"] for r in runs)}),
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
