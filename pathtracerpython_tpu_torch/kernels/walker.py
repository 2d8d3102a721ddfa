"""K9: the walker any-hit for shadow rays — CUDA kernel wrapper and plain
version.

The JAX package's ``kernels/walker_pallas.py`` walks, for each block of
``R_BLK = 1280`` shadow rays, the block's front-to-back candidate clusters
(``walker_worklist``: the sparse builder's interval slab test, limited to
the block's largest occlusion window) and stops the whole walk once the
next cluster's entry bound exceeds every unoccluded ray's window. The
hybrid hierarchy runs it for the NEE's shadow rays.

The port keeps the lists (``walker_lists``, complete, so no overflow and
no fallback) and the stop, compared in floats. Left behind as TPU
machinery: the 128-column tiles with the AABB stashed in row 0
(``_pack_walker``), the 19-bit quantized entry words and the flat SMEM list
budget (``W_SMEM_MAX``); the kernel reads the [T, 12] pack and the
[C, 8] AABBs directly.

On a CUDA tensor the wrapper launches ``csrc/walker_any_hit.cu`` (or
raises); on a CPU tensor it runs ``walker_any_hit_plain``, the same walk in
PyTorch, vectorized over ray blocks slot by slot. Forward only.
"""

from __future__ import annotations

import ctypes

import torch

from pathtracerpython_tpu_torch.kernels import build
from pathtracerpython_tpu_torch.kernels.intersect import (
    T_MIN,
    check_input,
    mt_rows,
)
from pathtracerpython_tpu_torch.kernels.sparse import (
    SLAB_EPS,
    BlockLists,
    block_lists,
    block_rays,
    by_block_chunks,
    cluster_aabbs,
    cluster_rows,
    lane_slab,
    pack_for_sparse,
    pad_repeat_last,
)

R_BLK = 1280  # shadow rays per block

# Launches of the CUDA kernel since the count was last reset.
LAUNCHES = 0

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # o3, d3, maxd
    ctypes.c_int,                                       # n
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,     # tripack, aabb8, C
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ids, keys, ncand
    ctypes.c_int,                                       # r_blk
    ctypes.c_void_p,                                    # occ_out
    ctypes.c_int, ctypes.c_void_p,                      # device, stream
]


def walker_lists(aabb8, o3, d3_unit, maxd) -> BlockLists:
    """Every block's candidate clusters within the block's largest window
    ``maxd``, front to back (``walker_worklist``, uncapped)."""
    nrb = -(-o3.shape[1] // R_BLK)
    tmax = pad_repeat_last(maxd, R_BLK).reshape(nrb, R_BLK).amax(dim=1)
    return block_lists(aabb8, o3, d3_unit, tmax, R_BLK)


def walker_any_hit_plain(o3, d3_unit, maxd, tripack, aabb8,
                         lists: BlockLists, r_blk: int) -> torch.Tensor:
    """The walk of ``csrc/walker_any_hit.cu`` in PyTorch: slot s of every
    block's list at once, with the kernel's per-lane gate, first-hit stop
    and whole-walk stop (taken per block instead of per CTA, which changes
    no result). Returns occlusion bool[N]."""
    def walk(rows, chunk: BlockLists):
        o3c, d3c, mdc = rows
        n, nrb = o3c.shape[1], chunk.ncand.shape[0]
        rays = block_rays(o3c, d3c, nrb, r_blk)
        md = pad_repeat_last(mdc, r_blk).reshape(nrb, 1, r_blk)
        t_cut = md - T_MIN
        can = rays.live & (t_cut > T_MIN)   # a blocking hit is possible
        open_ = can.clone()                 # not occluded yet
        walking = torch.ones(nrb, dtype=torch.bool, device=o3c.device)
        for s in range(int(chunk.ncand.max())):
            key = chunk.keys[:, s][:, None, None]
            walking = walking & (s < chunk.ncand) & (
                open_ & (key <= md + SLAB_EPS)).flatten(1).any(dim=1)
            if not bool(walking.any()):
                break
            cl = chunk.ids[:, s]
            box = aabb8[cl.to(torch.int64)][:, None, None, :]
            slab, enter0 = lane_slab(box, rays.o, rays.inv)
            needed = (walking[:, None, None] & open_ & slab
                      & (enter0 < md + SLAB_EPS))
            tri = cluster_rows(tripack, cl)
            hit, t = mt_rows(tri, *rays.o, *rays.d)
            blocking = hit & (tri[..., 10:11] > 0.5) & (t < t_cut)
            open_ = open_ & ~(needed & blocking.any(dim=1, keepdim=True))
        return [(can & ~open_).reshape(-1)[:n]]

    return by_block_chunks(walk, o3, [o3, d3_unit, maxd], lists, r_blk)[0]


def walker_any_hit_cm(o3: torch.Tensor, d3_unit: torch.Tensor,
                      maxd: torch.Tensor, scene) -> torch.Tensor:
    """Whether an occluder triangle blocks each shadow ray o3/d3_unit
    f32[3, N] (d3_unit of unit length) at t < maxd - 1e-4, through the
    cluster hierarchy in blocks of R_BLK rays; bool[N], the result of the
    dense ``any_hit_cm``. Lanes with maxd = 0 (parked) are never
    occluded."""
    device = o3.device
    n = o3.shape[1] if o3.dim() == 2 else -1
    check_input("o3", o3, device, torch.float32, (3, None))
    check_input("d3_unit", d3_unit, device, torch.float32, (3, n))
    check_input("maxd", maxd, device, torch.float32, (n,))
    tripack = pack_for_sparse(scene)
    check_input("scene triangles", tripack, device, torch.float32, (None, 12))
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no walker any-hit kernel for device {device}")
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=device)
    aabb8 = cluster_aabbs(tripack)
    lists = walker_lists(aabb8, o3, d3_unit, maxd)
    if device.type == "cpu":
        return walker_any_hit_plain(o3, d3_unit, maxd, tripack, aabb8, lists,
                                    R_BLK)
    return _launch(o3, d3_unit, maxd, tripack, aabb8, lists, R_BLK)


def _launch(o3, d3_unit, maxd, tripack, aabb8, lists, r_blk):
    global LAUNCHES
    n = o3.shape[1]
    occ = torch.empty(n, dtype=torch.bool, device=o3.device)
    fn = build.function("ptt_walker_any_hit", _ARGTYPES)
    stream = torch.cuda.current_stream(o3.device).cuda_stream
    err = fn(o3.data_ptr(), d3_unit.data_ptr(), maxd.data_ptr(), n,
             tripack.data_ptr(), aabb8.data_ptr(), aabb8.shape[0],
             lists.ids.data_ptr(), lists.keys.data_ptr(),
             lists.ncand.data_ptr(), r_blk, occ.data_ptr(), o3.device.index,
             stream)
    if err != 0:
        raise RuntimeError(
            f"walker any-hit kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return occ
