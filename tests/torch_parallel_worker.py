"""One rank of the port's sharded tests on the CPU (gloo), started by the
module fixtures of tests/test_torch_ring.py, test_torch_parallel.py,
test_torch_pipeline.py and test_torch_sharded_train.py (``spawn_ranks``)::

    python tests/torch_parallel_worker.py SUITE WORLD RANK INIT OUT_DIR

Joins a gloo group of WORLD ranks through the ``file://`` rendezvous INIT,
runs the suite's cases on one intra-op thread and saves what this rank got
as ``OUT_DIR/SUITE_RANK.npz`` (numpy arrays; an exception's message under a
``raised:`` key), for the test process to hold against the single-process
port and the JAX package. It imports the port only, never JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np


def spawn_ranks(suite: str, world: int, out_dir: str,
                timeout: float = 300.0) -> list[dict]:
    """Run ``suite`` on ``world`` gloo ranks; returns each rank's arrays.
    Fails with every rank's output if one fails."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": os.pathsep
           .join(p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    init = "file://" + os.path.join(out_dir, f"rendezvous_{suite}_{world}")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), suite, str(world),
         str(r), init, out_dir], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"suite {suite} on {world} ranks failed:\n"
                           + "\n".join(log[-4000:] for log in logs))
    out = []
    for r in range(world):
        with np.load(os.path.join(out_dir, f"{suite}_{r}.npz")) as f:
            out.append({k: f[k] for k in f.files})
    return out


# --- the cases (imported only in the rank processes) -----------------------

def ring_rays(scene, n: int, seed: int):
    """Seeded rays [n, 3] through the scene's bounds, and shadow lengths."""
    import torch

    rng = np.random.default_rng(seed)
    v = scene.tri_v0[scene.tri_valid].numpy()
    lo, hi = v.min(axis=0), v.max(axis=0)
    o = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    target = rng.uniform(lo, hi, size=(n, 3)).astype(np.float32)
    d = target - o
    maxd = np.linalg.norm(d, axis=1).astype(np.float32)
    return (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(maxd))


def tiled_scene(scene, copies: int):
    """The scene's triangle buffer repeated ``copies`` times: each row has
    exact twins in every shard of a ring of ``copies``, so every hit ties
    across shards and the lowest global row must win."""
    import dataclasses

    import torch

    from pathtracerpython_tpu_torch.scene.arrays import TRI_FIELDS

    return dataclasses.replace(scene, **{
        f: torch.cat([getattr(scene, f)] * copies) for f in TRI_FIELDS})


def ring_scenes(world: int) -> dict:
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import (
        box_field_scene,
        cornell_box_scene,
    )

    field = pack_scene(box_field_scene(n_boxes=24, width=8, height=8),
                       pad_to=32, device="cpu")
    cornell = pack_scene(cornell_box_scene(8, 8), pad_to=32, device="cpu")
    return {"field": field, "tie": tiled_scene(cornell, world)}


def suite_ring(world: int, save) -> None:
    """Ring sweeps over geom = world against nothing here: the test holds
    them against the dense sweeps of one process."""
    import torch

    from pathtracerpython_tpu_torch.ops.geometry import (
        any_hit_within_cm,
        first_occluder_index,
        nearest_hit_cm,
        normalize3,
    )
    from pathtracerpython_tpu_torch.parallel import make_mesh, shard_scene
    from pathtracerpython_tpu_torch.parallel.mesh import active

    mesh = make_mesh(dp=1, geom=world)
    for name, scene in ring_scenes(world).items():
        o, d, maxd = ring_rays(scene, 300, seed=5)
        o3, d3 = o.T.contiguous(), d.T.contiguous()
        d3u = normalize3(d3)
        shard = shard_scene(scene, mesh, "geom")
        with active(mesh), torch.no_grad():
            for mode in ("fast", "reference"):
                hit = nearest_hit_cm(o3, d3, shard, mode=mode,
                                     geom_axis="geom")
                for f in ("hit", "t", "tri_idx", "point3", "normal3",
                          "material", "is_light"):
                    save[f"{name}_{mode}_{f}"] = getattr(hit, f)
                save[f"{name}_{mode}_occ"] = any_hit_within_cm(
                    o3, d3u, maxd, shard, mode=mode, geom_axis="geom")
            idx, mat = first_occluder_index(o, d, maxd, shard,
                                            geom_axis="geom")
            save[f"{name}_first_idx"], save[f"{name}_first_mat"] = idx, mat


def render_cases(world: int) -> dict:
    """name -> (scene, cfg, mesh kwargs, geom_axis) of the sharded renders
    held against the single-process render."""
    import dataclasses

    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import (
        box_field_scene,
        cornell_box_scene,
    )

    cornell = pack_scene(cornell_box_scene(8, 8), pad_to=32, device="cpu")
    # 7 x 7 = 49 rays: padded to a multiple of the ray shards
    odd = pack_scene(cornell_box_scene(7, 7), pad_to=32, device="cpu")
    large = pack_scene(box_field_scene(n_boxes=400, width=7, height=7),
                       tri_order="morton", device="cpu")
    fast = RenderConfig(n_samples=2, n_bounces=2)
    ref = RenderConfig(mode="reference", n_samples=2, n_bounces=2)
    batched = dataclasses.replace(fast, batch_samples=True)
    cases = {
        "dp_fast": (cornell, fast, dict(dp=world), None),
        "dp_batched": (cornell, batched, dict(dp=world), None),
        "dp_odd": (odd, fast, dict(dp=world), None),
        "dp_reference": (cornell, ref, dict(dp=world), None),
        # a large scene: the hybrid, with wavefront and NEE sorting on, over
        # padded shards
        "dp_large_sorted": (large, dataclasses.replace(batched,
                                                       sort_rays="on"),
                            dict(dp=world), None),
        "ring_fast": (cornell, fast, dict(dp=1, geom=world), "geom"),
        "ring_reference": (cornell, ref, dict(dp=1, geom=world), "geom"),
        "ring_odd": (odd, batched, dict(dp=1, geom=world), "geom"),
    }
    if world == 4:
        # four ranks add the 4-way splits: the ring of 4 shards, dp x geom,
        # and the sorted large scene over 4 padded ray shards
        cases = {k: cases[k] for k in ("dp_large_sorted", "ring_fast",
                                       "ring_reference")}
        cases["dp_ring_fast"] = (cornell, fast, dict(dp=2, geom=2), "geom")
        cases["dp_ring_reference"] = (cornell, ref, dict(dp=2, geom=2),
                                      "geom")
    return cases


def mesh_cache():
    """``make_mesh(**kw)`` made once per shape: each mesh creates its
    process groups collectively, the slowest part of a small suite."""
    from pathtracerpython_tpu_torch.parallel import make_mesh

    made = {}

    def get(**kw):
        key = tuple(sorted(kw.items()))
        if key not in made:
            made[key] = make_mesh(**kw)
        return made[key]

    return get


def suite_render(world: int, save) -> None:
    import torch

    from pathtracerpython_tpu_torch.parallel import multihost, render_sharded

    # every rank's part, on every rank's host
    save["fetch"] = multihost.fetch_to_host(
        torch.full((2,), float(multihost.rank())))
    make_mesh = mesh_cache()
    for name, (scene, cfg, mesh_kw, geom_axis) in render_cases(world).items():
        mesh = make_mesh(**mesh_kw)
        with torch.no_grad():
            save[name] = render_sharded(scene, cfg, mesh, seed=3,
                                        geom_axis=geom_axis)


PIPELINE_CASES = {2: ((2, 4),), 4: ((4, 4), (2, 4), (4, 8))}


def suite_pipeline(world: int, save) -> None:
    import torch

    from pathtracerpython_tpu_torch.parallel import (
        make_mesh,
        render_pipelined,
    )
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import cornell_box_scene

    scene = pack_scene(cornell_box_scene(8, 8), pad_to=32, device="cpu")
    for pp, bounces in PIPELINE_CASES[world]:
        cfg = RenderConfig(mode="fast", n_samples=2, n_bounces=bounces)
        mesh = make_mesh(pp=pp, dp=world // pp)
        with torch.no_grad():
            save[f"pp{pp}_b{bounces}"] = render_pipelined(
                scene, cfg, mesh, seed=3, pp_axis="pp")
    if world == 2:
        mesh = make_mesh(pp=2, dp=1)
        cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=2)
        with torch.no_grad():
            for m in (4, 16):
                save[f"microbatches{m}"] = render_pipelined(
                    scene, cfg, mesh, microbatches=m)
        try:
            render_pipelined(scene, RenderConfig(n_samples=1, n_bounces=3),
                             mesh)
        except ValueError as e:
            save["raised:uneven"] = np.array(str(e))
        save["mesh_groups"] = np.array(sorted(",".join(k)
                                              for k in mesh.groups))
        try:
            mesh.line(("pp", "dp"))
        except ValueError as e:
            save["raised:line"] = np.array(str(e))


def train_cases(world: int) -> dict:
    """name -> (optimizer, params names, mesh kwargs, geom_axis)."""
    cases = {"sgd_dp": ("sgd", ("mat_rgb",), dict(dp=world), None),
             "adam_dp": ("adam", ("mat_rgb", "light_color", "eye"),
                         dict(dp=world), None),
             "vertex_dp": ("sgd", ("tri_v0",), dict(dp=world), None)}
    if world == 2:
        cases["sgd_ring"] = ("sgd", ("mat_rgb",), dict(dp=1, geom=2), "geom")
        cases["adam_ring"] = ("adam", ("mat_rgb", "light_color", "eye"),
                              dict(dp=1, geom=2), "geom")
    else:
        cases["sgd_ring"] = ("sgd", ("mat_rgb",), dict(dp=2, geom=2), "geom")
        cases["adam_ring"] = ("adam", ("mat_rgb", "light_color", "eye"),
                              dict(dp=2, geom=2), "geom")
    return cases


def train_start(scene, names) -> dict:
    """The starting params of the sharded-train cases."""
    scale = {"mat_rgb": 0.8, "light_color": 1.5}
    out = {}
    for k in names:
        v = getattr(scene, k)
        out[k] = v * scale[k] if k in scale else v + 0.05
    return out


def make_optimizer(kind: str, params: list):
    import torch

    from pathtracerpython_tpu_torch.diff import adam

    return (torch.optim.SGD(params, lr=0.1) if kind == "sgd"
            else adam(1e-2)(params))


def train_scene():
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import flat_scene

    return pack_scene(flat_scene(), device="cpu")


def suite_train(world: int, save) -> None:
    import torch

    from pathtracerpython_tpu_torch.diff import make_train_step
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render

    make_mesh = mesh_cache()
    scene = train_scene()
    cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=2)
    with torch.no_grad():
        target = render(scene, cfg, seed=1)
    for name, (kind, names, mesh_kw, geom_axis) in train_cases(world).items():
        params = {k: v.clone().requires_grad_(True)
                  for k, v in train_start(scene, names).items()}
        opt = make_optimizer(kind, list(params.values()))
        step = make_train_step(opt, scene, cfg, target,
                               mesh=make_mesh(**mesh_kw), geom_axis=geom_axis)
        save[f"{name}:loss"] = step(params, (0, 5))
        for k, v in params.items():
            save[f"{name}:{k}"] = v.detach()
    # the triangle buffers under a ring: refused, never silently zero
    params = {"tri_v0": scene.tri_v0.clone().requires_grad_(True)}
    step = make_train_step(make_optimizer("sgd", list(params.values())),
                           scene, cfg, target, mesh=make_mesh(
                               dp=world // 2, geom=2), geom_axis="geom")
    try:
        step(params, (0, 5))
    except NotImplementedError as e:
        save["raised:tri_ring"] = np.array(str(e))


SUITES = {"ring": suite_ring, "render": suite_render,
          "pipeline": suite_pipeline, "train": suite_train}


def main() -> None:
    suite, world, rank, init, out_dir = sys.argv[1:6]
    world, rank = int(world), int(rank)
    import torch

    torch.set_num_threads(1)
    from pathtracerpython_tpu_torch.parallel import multihost

    multihost.initialize(init_method=init, world_size=world, rank=rank,
                         platform="cpu", log=lambda *a: None)
    saved: dict = {}
    try:
        SUITES[suite](world, saved)
        multihost.sync()
    finally:
        multihost.shutdown()
    arrays = {k: (v.detach().numpy() if isinstance(v, torch.Tensor) else v)
              for k, v in saved.items()}
    np.savez(os.path.join(out_dir, f"{suite}_{rank}.npz"), **arrays)


if __name__ == "__main__":
    main()
