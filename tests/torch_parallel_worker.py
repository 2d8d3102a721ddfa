"""One rank of the port's sharded tests on the CPU (gloo), started by the
module fixtures of tests/test_torch_ring.py, test_torch_parallel.py,
test_torch_pipeline.py, test_torch_sharded_train.py, test_torch_ring_grad.py
and test_torch_soft_ring.py (``spawn_ranks``)::

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
    # the triangle buffers under a ring: their gradients flow around it
    params = {k: v.clone().requires_grad_(True)
              for k, v in train_start(scene, ("tri_v0",)).items()}
    step = make_train_step(make_optimizer("sgd", list(params.values())),
                           scene, cfg, target, mesh=make_mesh(
                               dp=world // 2, geom=2), geom_axis="geom")
    save["tri_ring:loss"] = step(params, (0, 5))
    save["tri_ring:tri_v0"] = params["tri_v0"].detach()
    save["tri_ring:grad"] = params["tri_v0"].grad


# --- gradients around the ring ----------------------------------------------

VERTS = ("tri_v0", "tri_v1", "tri_v2")


def nearest_loss(hit, w) -> "torch.Tensor":
    """A seeded linear form of a nearest record's t, point and normal over
    the lanes that hit (what a miss's record holds is no one's gradient):
    its gradient reaches every winning row."""
    import torch

    w = torch.where(hit.hit, w, 0.0)
    return ((w[0] * hit.t).sum() + (w[1:4] * hit.point3).sum()
            + (w[4:7] * hit.normal3).sum())


def nearest_weights(n: int, seed: int = 11):
    import torch

    return torch.from_numpy(np.random.default_rng(seed).uniform(
        -1.0, 1.0, (7, n)).astype(np.float32))


def away_rays(scene, n: int):
    """``n`` rays that start outside the scene's bounds and point away from
    it: they hit nothing."""
    import torch

    v = scene.tri_v0[scene.tri_valid]
    hi = v.max(dim=0).values
    o = (hi + 10.0).expand(n, 3).clone()
    o[:, 0] += torch.linspace(0.0, 1.0, n)
    return o, torch.tensor([[1.0, 2.0, 3.0]]).expand(n, 3).clone()


def nearest_grad_rays(scene, world: int, rank: int, name: str):
    """The rays of a ``suite_ring_grad`` nearest case and the lanes of
    them this rank sweeps: every world-th ray from its rank; in the "nohit"
    case rank 0's share points away from the scene."""
    import torch

    o, d, _ = ring_rays(scene, 300, seed=5)
    if name == "nohit":
        mine = torch.arange(300) % world == 0
        ao, ad = away_rays(scene, int(mine.sum()))
        o, d = o.clone(), d.clone()
        o[mine], d[mine] = ao, ad
    return o, d, torch.arange(rank, 300, world)


def grad_scenes(world: int) -> dict:
    """name -> scene of the nearest-gradient cases: the ring scenes, and
    the box field again for the case where rank 0's rays hit nothing."""
    scenes = ring_scenes(world)
    scenes["nohit"] = scenes["field"]
    return scenes


def ring_train_scene(name: str):
    """The scenes of the ring training cases: the Cornell stand-in at 8x8
    (36 triangles in 64 rows, so every shard of 2 or 4 holds some), and
    the flat scene seen from tests/test_diff.py's offset eye (no pixel
    grazes an edge, so the JAX package names the same winners)."""
    import dataclasses

    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import (
        cornell_box_scene,
        flat_scene,
    )

    if name == "flat":
        desc = flat_scene()
        desc = dataclasses.replace(desc, eye=tuple(
            float(e + o) for e, o in zip(desc.eye, (0.03, -0.02, 0.05))))
        return desc, pack_scene(desc, device="cpu")
    desc = cornell_box_scene(8, 8)
    return desc, pack_scene(desc, pad_to=32, device="cpu")


def ring_train_cases(world: int) -> dict:
    """name -> (optimizer, params, mesh kwargs, scene, config overrides)
    of the ring training cases: vertex and light-vertex params in fast and
    reference mode, with and without ``remat_bounces``."""
    verts = ("tri_v0", "tri_v1", "light_v0")
    ring = dict(dp=1, geom=2) if world == 2 else dict(dp=2, geom=2)
    cases = {"sgd": ("sgd", verts, ring, "cornell", {}),
             "adam": ("adam", verts, ring, "cornell", {}),
             "sgd_remat": ("sgd", verts, ring, "cornell",
                           {"remat_bounces": True})}
    if world == 2:
        cases["sgd_reference"] = ("sgd", verts, ring, "cornell",
                                  {"mode": "reference"})
        cases["jax_flat"] = ("sgd", ("tri_v0",), ring, "flat", {})
    else:
        cases["adam_geom4"] = ("adam", verts, dict(dp=1, geom=4),
                               "cornell", {})
    return cases


RING_TRAIN_CFG = dict(mode="fast", n_samples=1, n_bounces=2)


def ring_train_setup(scene_name: str, kind: str, names, overrides: dict):
    """(scene, config, target, params, optimizer) of a ring training case;
    the target is the scene's own render, the params start off it."""
    import torch

    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render

    _, scene = ring_train_scene(scene_name)
    cfg = RenderConfig(**{**RING_TRAIN_CFG, **overrides})
    with torch.no_grad():
        target = render(scene, cfg, seed=1)
    params = {k: (getattr(scene, k) + 0.05).clone().requires_grad_(True)
              for k in names}
    return scene, cfg, target, params, make_optimizer(
        kind, list(params.values()))


def suite_ring_grad(world: int, save) -> None:
    """Triangle gradients around the ring: the nearest sweep's (fast and
    reference mode, each rank sweeping its share of the rays), the sharded
    training steps and a fit, and the ring's traffic counts."""
    import torch

    from pathtracerpython_tpu_torch.diff import adam, fit, make_train_step
    from pathtracerpython_tpu_torch.diff.inverse import apply_params
    from pathtracerpython_tpu_torch.ops.geometry import nearest_hit_cm
    from pathtracerpython_tpu_torch.parallel import (
        multihost,
        ring,
        shard_scene,
    )
    from pathtracerpython_tpu_torch.parallel.mesh import active

    make_mesh = mesh_cache()
    rank = multihost.rank()
    mesh = make_mesh(dp=1, geom=world)
    for name, scene in grad_scenes(world).items():
        o, d, mine = nearest_grad_rays(scene, world, rank, name)
        w = nearest_weights(o.shape[0])[:, mine]
        for mode in ("fast", "reference"):
            leaves = {f: getattr(scene, f).clone().requires_grad_(True)
                      for f in VERTS}
            shard = shard_scene(apply_params(scene, leaves), mesh, "geom")
            ring.reset_counts()
            with active(mesh):
                hit = nearest_hit_cm(o[mine].T.contiguous(),
                                     d[mine].T.contiguous(), shard,
                                     mode=mode, geom_axis="geom")
            nearest_loss(hit, w).backward()
            key = f"nearest:{name}:{mode}"
            for f, v in leaves.items():
                save[f"{key}:{f}"] = v.grad
            save[f"{key}:hits"] = hit.hit.sum()
            save[f"{key}:counts"] = np.array(
                [ring.SHIFTS, ring.BACK_SHIFTS, ring.BYTES_SENT,
                 ring.BACK_BYTES])
    for name, (kind, names, mesh_kw, scene_name, over) in \
            ring_train_cases(world).items():
        scene, cfg, target, params, opt = ring_train_setup(scene_name, kind,
                                                           names, over)
        step = make_train_step(opt, scene, cfg, target,
                               mesh=make_mesh(**mesh_kw), geom_axis="geom")
        ring.reset_counts()
        save[f"{name}:loss"] = step(params, (0, 5))
        save[f"{name}:counts"] = np.array(
            [ring.SHIFTS, ring.BACK_SHIFTS, ring.BYTES_SENT,
             ring.BACK_BYTES])
        for k, v in params.items():
            save[f"{name}:{k}"] = v.detach()
            save[f"{name}:grad:{k}"] = v.grad
    if world == 2:
        scene, cfg, target, params, _ = ring_train_setup(
            "cornell", "adam", ("tri_v2", "light_v1"), {})
        got, losses = fit(params, adam(1e-2), scene, cfg, target, steps=2,
                          seed=4, mesh=mesh, geom_axis="geom")
        save["fit:losses"] = np.array(losses)
        for k, v in got.items():
            save[f"fit:{k}"] = v
        # rank 0 numbers one shift more than rank 1 before a sweep of one
        # reverse shift: both ranks must raise (a longer ring would leave
        # the ranks that matched waiting on the next one)
        scene = grad_scenes(world)["field"]
        o, d, mine = nearest_grad_rays(scene, world, rank, "field")
        leaves = {f: getattr(scene, f).clone().requires_grad_(True)
                  for f in VERTS}
        shard = shard_scene(apply_params(scene, leaves), mesh, "geom")
        _, key = mesh.line("geom")
        ring._MADE[key] += rank == 0
        with active(mesh):
            hit = nearest_hit_cm(o[mine].T.contiguous(),
                                 d[mine].T.contiguous(), shard,
                                 geom_axis="geom")
        ring._MADE[key] -= rank == 0
        try:
            nearest_loss(hit, nearest_weights(o.shape[0])[:, mine]).backward()
            save["mispaired"] = np.array("no error")
        except RuntimeError as e:
            save["mispaired"] = np.array(str(e))


# --- the soft estimator on the ring -------------------------------------------

SOFT_BETA = 0.05     # tests/test_torch_soft_render.py's
SOFT_SEED = 3
SOFT_PLANS = {"1spp1b": (1, 1), "2spp2b": (2, 2)}
# the JAX package's shard-local fault: tests/test_boundary.py's occluder
# scene, beta 0.03, 1 bounce, 1 spp, seed 1
FAULT_KW = dict(n_samples=1, n_bounces=1, soft_vis_beta=0.03)
FAULT_SEED = 1


def soft_scenes() -> dict:
    """name -> (scene, the material row of the object that moves): the
    occluder scene (128 rows) and the Cornell stand-in at 16x16 (64)."""
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import (
        cornell_box_scene,
        occluder_scene,
    )

    return {"occluder": (pack_scene(occluder_scene(), device="cpu"), 1),
            "cornell": (pack_scene(cornell_box_scene(16, 16), pad_to=32,
                                   device="cpu"), 5)}


def soft_cfg(plan: str):
    from pathtracerpython_tpu_torch.render.config import RenderConfig

    spp, bounces = SOFT_PLANS[plan]
    return RenderConfig(n_samples=spp, n_bounces=bounces, n_light_samples=2,
                        soft_vis_beta=SOFT_BETA)


def soft_grad_cases() -> dict:
    """name -> (scene name, plan, what moves): the rigid translation of the
    moving object, and ``tri_v0`` on the stand-in at 1 spp, 1 bounce."""
    cases = {f"{s}:{p}:move": (s, p, "move")
             for s in ("occluder", "cornell") for p in SOFT_PLANS}
    cases["cornell:1spp1b:tri_v0"] = ("cornell", "1spp1b", "tri_v0")
    return cases


def soft_loss_and_grad(case: str, mesh=None):
    """(loss, d loss / d param) of 0.5 * mean squared error against a
    seeded target; with a ``mesh`` the render is sharded over dp x geom
    (geom the ring) and the gradient summed over the ray axes."""
    import dataclasses

    import torch

    from pathtracerpython_tpu_torch.diff import make_render_fn, transforms
    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
    from pathtracerpython_tpu_torch.parallel.multihost import transport
    from pathtracerpython_tpu_torch.scene.arrays import recompute_derived

    name, plan, what = soft_grad_cases()[case]
    scene, obj = soft_scenes()[name]
    w, h = scene.meta.width, scene.meta.height
    target = torch.from_numpy(np.random.default_rng(0).uniform(
        0.0, 0.5, (w * h, 3)).astype(np.float32))
    if what == "move":
        p = torch.tensor([0.05, -0.03], requires_grad=True)
        moved = transforms.translate_object(
            scene, obj, torch.stack([p[0], torch.zeros(()), p[1]]))
    else:
        p = scene.tri_v0.clone().requires_grad_(True)
        moved = recompute_derived(dataclasses.replace(scene, tri_v0=p))
    fn = make_render_fn(soft_cfg(plan), mesh=mesh,
                        geom_axis=None if mesh is None else "geom")
    o, d = make_primary_rays(scene.eye, scene.ortho, w, h)
    loss = 0.5 * ((fn(o, d, torch.arange(w * h), moved, (0, SOFT_SEED))
                   - target) ** 2).mean()
    loss.backward()
    grad = p.grad
    if mesh is not None:
        group, ranks = mesh.line(("dp", "geom"))
        if len(ranks) > 1:
            grad = transport("all_reduce", grad, group)
    return loss.detach(), grad


def suite_soft_ring(world: int, save) -> None:
    """The soft sweeps on a ring of ``world`` shards: the records of seeded
    rays, soft renders, and the translation and vertex gradients; at 2
    ranks also the render of the JAX package's shard-local fault."""
    import torch

    from pathtracerpython_tpu_torch.parallel import render_sharded, shard_scene
    from pathtracerpython_tpu_torch.parallel.mesh import active
    from pathtracerpython_tpu_torch.parallel.ring import soft_hits_ring
    from pathtracerpython_tpu_torch.render.config import RenderConfig

    make_mesh = mesh_cache()
    mesh = make_mesh(dp=1, geom=world)
    for name, scene in ring_scenes(world).items():
        o, d, _ = ring_rays(scene, 300, seed=5)
        with active(mesh), torch.no_grad():
            sh, attrs = soft_hits_ring(o, d, shard_scene(scene, mesh, "geom"),
                                       SOFT_BETA, "geom")
        for f, v in sh._asdict().items():
            save[f"records:{name}:{f}"] = v
        for rec, a in attrs.items():
            for f, v in a._asdict().items():
                save[f"records:{name}:{rec}:{f}"] = v
    for name, (scene, _) in soft_scenes().items():
        for plan in SOFT_PLANS:
            with torch.no_grad():
                save[f"render:{name}:{plan}"] = render_sharded(
                    scene, soft_cfg(plan), mesh, seed=SOFT_SEED,
                    geom_axis="geom")
    for case in soft_grad_cases():
        loss, grad = soft_loss_and_grad(case, mesh)
        save[f"grad:{case}:loss"], save[f"grad:{case}"] = loss, grad
    if world == 2:
        scene = soft_scenes()["occluder"][0]
        with torch.no_grad():
            save["fault:ring"] = render_sharded(
                scene, RenderConfig(**FAULT_KW), mesh, seed=FAULT_SEED,
                geom_axis="geom")


SUITES = {"ring": suite_ring, "render": suite_render,
          "pipeline": suite_pipeline, "train": suite_train,
          "ring_grad": suite_ring_grad, "soft_ring": suite_soft_ring}


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
