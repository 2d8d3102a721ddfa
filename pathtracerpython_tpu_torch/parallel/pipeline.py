"""Pipeline parallelism: bounce stages over a ``pp`` mesh axis (the JAX
package's ``parallel/pipeline.py`` on ``torch.distributed``).

The bounce loop, the renderer's depth, is split into contiguous equal
ranges over the ranks of the ``pp`` axis, the pixel wavefront into
microbatches, and each microbatch's whole ray state
(``render.integrator.RayState``) is sent from stage to stage after its
bounces there. Stage 0 makes each microbatch's primary rays; the last stage
keeps its radiance, and broadcasts the image to every stage at the end.

Semantics: bit-identical to the single-device per-sample plan
(``render_rays`` with ``batch_samples=False``): every lane passes through
the same ``bounce_step`` calls in the same order with the same counters
(global pixel id * spp + sample), no sorting, and the sample passes are
summed in the same order. A plain send / recv per stage and microbatch
replaces JAX's lock-step M + P - 1 schedule: a stage starts a microbatch as
soon as it arrives, so stages overlap as the schedule's do. Ranks of other
axes (dp) each run the whole pipeline over the whole image.

When to use: a path has no per-stage weights, so data parallelism
(``parallel/shard.py``) is the production axis; the pipeline is the tested
mapping of the strategy, which trades a bubble for a different
communication pattern (state hops instead of a final gather).
"""

from __future__ import annotations

import torch

from pathtracerpython_tpu_torch.ops import rng
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.parallel import mesh as mesh_mod
from pathtracerpython_tpu_torch.parallel.multihost import (
    pack_tensors,
    transport,
    unpack_tensors,
)
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import (
    RayState,
    bounce_step,
    check_counter_space,
    init_rays,
)
from pathtracerpython_tpu_torch.scene.arrays import SceneTensors


def render_pipelined(scene: SceneTensors, cfg: RenderConfig,
                     mesh: mesh_mod.Mesh, *, seed: int = 0,
                     pp_axis: str = "pp",
                     microbatches: int | None = None) -> torch.Tensor:
    """Render with bounce stages pipelined over ``mesh[pp_axis]``; returns
    radiance [W*H, 3] on every rank, bit-identical to ``render(scene,
    cfg)`` with ``batch_samples=False``.

    Refuses (``ValueError``) what the JAX package refuses: ``n_bounces`` not
    a multiple of the stage count, W*H not a multiple of ``microbatches``
    (default 2 x stages), and the soft estimator."""
    if cfg.soft_vis_beta > 0.0:
        raise ValueError("render_pipelined does not take the soft estimator "
                         "(as the JAX package's); use render or "
                         "render_sharded")
    group, ranks = mesh.line(pp_axis)
    p_size = len(ranks)
    stage = mesh.coords[pp_axis]
    n_b = cfg.n_bounces
    if n_b % p_size:
        raise ValueError(f"n_bounces={n_b} must divide evenly into "
                         f"pp={p_size} stages")
    bpp = n_b // p_size
    w, h = scene.meta.width, scene.meta.height
    n = w * h
    m = microbatches if microbatches is not None else 2 * p_size
    if n % m:
        raise ValueError(f"W*H={n} must be a multiple of microbatches={m}")
    n_mb = n // m
    s_total = cfg.n_samples
    check_counter_space(n, s_total)

    origins, dirs = make_primary_rays(scene.eye, scene.ortho, w, h)
    o3, d3 = origins.T, dirs.T
    pid = torch.arange(n, dtype=torch.int64, device=scene.device)
    k0, k1 = rng.key_from_seed(seed)
    first, last = stage == 0, stage == p_size - 1

    def ingest(sample: int, mb: int) -> RayState:
        lo = mb * n_mb
        return init_rays(o3[:, lo:lo + n_mb], d3[:, lo:lo + n_mb],
                         pid[lo:lo + n_mb] * s_total + sample)

    total3 = None
    for sample in range(s_total):
        pass3 = torch.zeros((3, n), dtype=o3.dtype, device=o3.device)
        for mb in range(m):
            state = ingest(sample, mb)
            if not first:
                # the fresh state is the template of the one received
                got = transport("recv", pack_tensors(state), group,
                                peer=ranks[stage - 1])
                state = RayState(*unpack_tensors(got, state))
            for i in range(bpp):
                state = bounce_step(state, stage * bpp + i, scene, cfg, k0,
                                    k1, None)
            if last:
                pass3[:, mb * n_mb:(mb + 1) * n_mb] = state.radiance3
            else:
                transport("send", pack_tensors(state), group,
                          peer=ranks[stage + 1])
        # the per-sample plan's sum, pass by pass in sample order
        total3 = pass3 if total3 is None else total3 + pass3
    if p_size > 1:
        total3 = transport("broadcast", total3, group, peer=ranks[-1])
    return (total3 / s_total).T
