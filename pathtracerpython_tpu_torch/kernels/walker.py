"""The walker hierarchy: K8, the walker nearest sweep, and K9, the walker
any-hit for shadow rays. CUDA kernel wrappers and plain versions.

The JAX package's ``kernels/walker_pallas.py`` walks, for each block of
``R_BLK = 1280`` rays, the block's front-to-back candidate clusters
(``walker_worklist``: the sparse lists' interval slab test, for shadow
rays limited to the block's largest occlusion window) and stops the whole
walk once the next cluster's entry bound exceeds what every ray can still
use: its best t (K8), or the window of every unoccluded ray (K9).
``accel="walker"`` runs both; the hybrid runs K9 for the NEE's shadow rays.

The port keeps the lists (``nearest_lists``, ``walker_lists``: complete, so
no overflow and no fallback) and the stop, compared in floats. K8 walks a
block's list in units of ``sparse.WALK_SEGMENT`` slots on many CTAs at
once, as K5 does (``csrc/cluster.cuh``); K9 runs K6's walk
(``csrc/any_hit_walk.cuh``): the same units, merged per lane by its
occlusion mark, and the in-cluster box cull. Left behind
as TPU machinery: the 128-column tiles with the AABB stashed in row 0
(``_pack_walker``), the 19-bit quantized entry words and the flat SMEM list
budget (``W_SMEM_MAX``); the kernels read the [T, 12] pack and the
[C, 8] AABBs directly.

Both sweeps are classic Möller–Trumbore only: the JAX package's
``walker_pallas.py`` has no Plücker body, so they do not follow the
``MT_IMPL`` knob of ``kernels/intersect.py``, and the hybrid under
"plucker" is the Plücker nearest sweep with the classic K9.

On a CUDA tensor each wrapper launches its kernel (``csrc/walker_nearest.cu``,
``csrc/walker_any_hit.cu``) or raises; on a CPU tensor it runs its plain
version: the walks of ``kernels/sparse.py`` (``sparse_nearest_plain``,
``any_hit_walk``) on the walker's lists, since K8 computes K5's function
and K9 K6's. K8 runs under ``intersect.nearest_entry``: the walk sees
detached rays and a detached scene, and the backward is the dense sweep's
re-solve on the scene's rows, so its gradients are K1's bit for bit. K9
detaches its inputs (``intersect.detach_occlusion``).
"""

from __future__ import annotations

import ctypes

import torch

from pathtracerpython_tpu_torch.kernels import build
from pathtracerpython_tpu_torch.kernels.intersect import (
    BIG,
    detach_occlusion,
    nearest_entry,
)
from pathtracerpython_tpu_torch.kernels.sparse import (
    BlockLists,
    any_hit_walk,
    block_lists,
    check_rays,
    launch_occlusion,
    scene_cluster_cull_boxes,
    sparse_nearest_plain,
    walk_words,
    window_lists,
)

R_BLK = 1280  # rays per block

# Launches of the CUDA kernels since the counts were last reset: K9, K8.
LAUNCHES = 0
NEAREST_LAUNCHES = 0

_NEAREST_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,     # o3, d3, n
    ctypes.c_void_p, ctypes.c_void_p,                   # tripack, aabb8
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ids, keys, ncand
    ctypes.c_int, ctypes.c_int,                         # n_cols, r_blk
    ctypes.c_void_p,                                    # words (all ones)
    ctypes.c_void_p, ctypes.c_void_p,                   # t_out, idx_out
    ctypes.c_void_p,                                    # stats (or null)
    ctypes.c_int, ctypes.c_void_p,                      # device, stream
]


def nearest_lists(aabb8, o3, d3_unit) -> BlockLists:
    """Every block's candidate clusters front to back, with no distance
    limit (``walker_worklist`` with tmax = BIG, uncapped)."""
    nrb = -(-o3.shape[1] // R_BLK)
    tmax = torch.full((nrb,), BIG, dtype=o3.dtype, device=o3.device)
    return block_lists(aabb8, o3, d3_unit, tmax, R_BLK)


def walker_lists(aabb8, o3, d3_unit, maxd) -> BlockLists:
    """Every block's candidate clusters within the block's largest window
    ``maxd``, front to back (``walker_worklist``, uncapped)."""
    return window_lists(aabb8, o3, d3_unit, maxd, R_BLK)


def walker_nearest_plain(o3, d3_unit, tripack, aabb8, lists: BlockLists,
                         r_blk: int, visits: list | None = None):
    """K8's plain version: ``sparse_nearest_plain``'s walk on the walker's
    lists (the same gate, merge and stop; the kernel stops per warp, the
    walk per block, which changes no result). Returns (t [N] — 0 on a
    miss, idx [N] int32 — -1 on a miss)."""
    return sparse_nearest_plain(o3, d3_unit, tripack, aabb8, lists, r_blk,
                                visits)


def walker_any_hit_plain(o3, d3_unit, maxd, tripack, aabb8,
                         lists: BlockLists, r_blk: int,
                         visits: list | None = None) -> torch.Tensor:
    """K9's plain version: occlusion bool[N] by ``any_hit_walk`` (the
    kernel's per-lane gate, first-hit stop and whole-walk stop)."""
    return any_hit_walk(o3, d3_unit, maxd, tripack, aabb8, lists, r_blk,
                        visits)[0]


def walker_nearest_t_idx_cm(o3: torch.Tensor, d3_unit: torch.Tensor, scene):
    """K8: closest forward hit of rays o3/d3_unit f32[3, N] (d3_unit of
    unit length) by walking each block of R_BLK rays' front-to-back
    candidate list; the result of the dense ``nearest_t_idx_cm``: (t [N] —
    0 on a miss, idx [N] int32 — -1 on a miss), and its gradients."""
    return nearest_entry(_walker_nearest_t_idx, o3, d3_unit, scene)


def _walker_nearest_t_idx(o3, d3_unit, scene):
    device = o3.device
    n, tripack, aabb8 = check_rays(o3, d3_unit, scene, "walker nearest-hit")
    if n == 0:
        return (torch.zeros(0, dtype=o3.dtype, device=device),
                torch.zeros(0, dtype=torch.int32, device=device))
    lists = nearest_lists(aabb8, o3, d3_unit)
    if device.type == "cpu":
        return walker_nearest_plain(o3, d3_unit, tripack, aabb8, lists, R_BLK)
    return _launch_nearest(o3, d3_unit, tripack, aabb8, lists, R_BLK)


def walker_any_hit_cm(o3: torch.Tensor, d3_unit: torch.Tensor,
                      maxd: torch.Tensor, scene) -> torch.Tensor:
    """Whether an occluder triangle blocks each shadow ray o3/d3_unit
    f32[3, N] (d3_unit of unit length) at t < maxd - 1e-4, through the
    cluster hierarchy in blocks of R_BLK rays; bool[N], the result of the
    dense ``any_hit_cm``. Lanes with maxd = 0 (parked) are never
    occluded."""
    o3, d3_unit, maxd, scene = detach_occlusion(o3, d3_unit, maxd, scene)
    n, tripack, aabb8 = check_rays(o3, d3_unit, scene, "walker any-hit",
                                   maxd)
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=o3.device)
    lists = walker_lists(aabb8, o3, d3_unit, maxd)
    if o3.device.type == "cpu":
        return walker_any_hit_plain(o3, d3_unit, maxd, tripack, aabb8, lists,
                                    R_BLK)
    return _launch(o3, d3_unit, maxd, tripack, aabb8, lists, R_BLK,
                   scene_cluster_cull_boxes(scene))


def _launch(o3, d3_unit, maxd, tripack, aabb8, lists, r_blk, cull,
            stats=None):
    global LAUNCHES
    occ = launch_occlusion(o3, d3_unit, maxd, tripack, aabb8, lists, r_blk,
                           "ptt_walker_any_hit", cull, stats)
    LAUNCHES += 1
    return occ


def _launch_nearest(o3, d3_unit, tripack, aabb8, lists, r_blk, stats=None):
    global NEAREST_LAUNCHES
    n = o3.shape[1]
    words = walk_words(n, o3.device)
    t = torch.empty(n, dtype=torch.float32, device=o3.device)
    idx = torch.empty(n, dtype=torch.int32, device=o3.device)
    fn = build.function("ptt_walker_nearest", _NEAREST_ARGTYPES)
    stream = torch.cuda.current_stream(o3.device).cuda_stream
    err = fn(o3.data_ptr(), d3_unit.data_ptr(), n, tripack.data_ptr(),
             aabb8.data_ptr(), lists.ids.data_ptr(), lists.keys.data_ptr(),
             lists.ncand.data_ptr(), lists.ids.shape[1], r_blk,
             words.data_ptr(), t.data_ptr(), idx.data_ptr(),
             None if stats is None else stats.data_ptr(), o3.device.index,
             stream)
    if err != 0:
        raise RuntimeError(
            f"walker nearest-hit kernel launch failed: CUDA error {err}")
    NEAREST_LAUNCHES += 1
    return t, idx
