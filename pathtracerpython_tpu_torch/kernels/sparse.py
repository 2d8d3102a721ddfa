"""The sparse hierarchy: K5, the cluster-sparse nearest sweep; K6, the
cluster-sparse shadow any-hit; K7, the any-hit that also reports the
blocking cluster, with the occluder cache's two passes around it; and the
cluster hierarchy's candidate lists. CUDA kernel wrappers and plain
versions.

The hierarchy of the JAX package's ``kernels/sparse_pallas.py``:

- **clusters**: the triangle pack, padded to a multiple of 512 rows, is cut
  into ``C_TRI = 128``-triangle clusters with AABBs (``cluster_aabbs``);
  ``pack_scene(tri_order="morton")`` makes them spatially tight;
- **candidate lists**: each block of ``r_blk`` consecutive rays gets the
  clusters any of its rays can touch, by an interval slab test of the
  block's (origin box x direction box) family against every cluster AABB
  (``candidate_enter_hit``), sorted front to back by that conservative
  entry bound (``block_lists``; ``window_lists`` limits them to the block's
  largest shadow window). The lists are complete (no cap), so there is no
  overflow and no fallback;
- **K5** ``sparse_nearest_t_idx_cm`` walks each block's list per ray; a ray
  tests a cluster only when its own slab test lets it through with entry
  < best t + SLAB_EPS. The winner is the lexicographic (t, global index)
  minimum, the dense K1's winner. Blocks of ``R_BLK = 512`` rays for
  ``accel="sparse"``, of ``R_BLK_HYBRID_NEAREST`` for the hybrid. On the
  card a block's list is walked in units of ``WALK_SEGMENT`` slots on many
  CTAs at once, each lane's best merged by a 64-bit atomicMin on (t,
  index) (``csrc/cluster.cuh``); ``sparse_nearest_plain(..., segment=)``
  models that walk;
- **K6** ``sparse_any_hit_cm``: whether an occluder triangle of a candidate
  cluster blocks each shadow ray inside its window; the dense K4's bits. On
  the card a block's list is walked in units of ``ANY_HIT_SEGMENT`` slots
  on many CTAs, merged per lane by its occlusion mark, each visited cluster's
  rows culled by span, mid and group boxes (``cluster_cull_boxes``;
  ``csrc/any_hit_walk.cuh``, shared with K9); ``any_hit_walk(...,
  cull=, segment=, order=)`` models that walk;
- **K7** ``sparse_any_hit_cached_cm``: K6's bits for any cache contents,
  plus the first blocking cluster in visit order per lane, which is the
  next bounce's cache. Pass 1 sweeps each block's ``K_GUESS`` most voted
  cached clusters (``guess_lists``); pass 2 sweeps the full lists of the
  lanes pass 1 left open, compacted when they fit ``n / CACHE_M_DIV``. On
  the card both passes run K6's walk (``csrc/any_hit_walk.cuh``: units,
  cull) merged per lane by an atomicMin on its first blocking list slot,
  so that a unit drops a lane only on a smaller slot than the one it
  reaches; ``any_hit_walk(..., merge="first_slot")`` models that walk.
  The open lanes are compacted by the compact entry of csrc/two_pass.cu
  (``select_compact``); choosing pass 2's form reads its ``taken`` word on
  the host once a call, where the JAX package branches on the device
  (``lax.cond``).

**K3, the Plücker form.** K5 and K6 follow the ``MT_IMPL`` knob of
``kernels/intersect.py`` (or their ``mt_impl`` keyword), as
``_sparse_plucker`` makes the JAX package's sparse sweeps follow it: under
"plucker" the same walks test a ray against the 36-column Plücker rows
(``scene_plucker_pack``; clusters, AABBs and lists stay the classic
pack's) and give the dense Plücker sweep's result bit for bit. K7 has no
Plücker form and stays classic under the knob, as in the JAX package.

**The two-pass protocol** of the uncached sweeps (``two_pass=`` /
``m_div=`` of K5's and K6's entries, and of K3's sparse sweeps; off by
default, as in the JAX package, unless TWO_PASS_NEAREST_AUTO /
TWO_PASS_ANY_AUTO are set): pass 1 walks the first PASS1_K slots of each
block's list (``truncate_lists``), the select-and-compact kernel
(csrc/two_pass.cu; plain twins ``two_pass_flags_plain`` and
``select_compact_plain``) keeps the lanes that pass 1 cannot have
finished and compacts them into pass 2's slots, and pass 2 sweeps those
again over their own lists (``two_pass_nearest``, ``two_pass_any_hit``);
where they do not fit, the whole wavefront is swept again, the branch
chosen on the device. The result is the one-pass result bit for bit. Both
passes run in the form of the ``mt_impl`` knob, where the JAX package's
pass 1 is always classic.

Left behind as TPU machinery: the packed [seg|active|rb|cl] work words,
the SMEM budgets (``W_PER_RB``, ``CHUNK_RB``, ``W_SMEM_ENTRIES``), grouping,
the grid cascade, the interpret-mode caps, and ``REFINE_K`` (0, which does
nothing, in the JAX package). The occluder cache's own two passes are
ported (K7).

On a CUDA tensor each wrapper launches its kernel (``csrc/sparse_nearest.cu``,
``csrc/sparse_any_hit.cu``, ``csrc/sparse_any_hit_idx.cu``,
``csrc/two_pass.cu``; the first two hold both forms) or raises; on a
CPU tensor it runs its plain version, the same walk (or the same
compaction) in PyTorch, the walks vectorized over ray blocks slot by
slot.

**Gradients.** K5 and K3's sparse nearest run under
``intersect.nearest_entry``, the dense sweep's ``NearestTIdx``: the walk
(its lists, boxes and sort keys too) sees detached rays and a detached
scene, and the backward re-solves each winner on the scene's own rows
(``scene_tripack``: the sparse pack is that pack with invalid rows
appended, so a winner's index names the same row). One re-solve over the
whole wavefront, as ``_entry_bwd`` has it, so the gradients are the dense
sweep's bit for bit. K6 and K7 detach their inputs
(``intersect.detach_occlusion``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from pathtracerpython_tpu_torch.kernels import build
from pathtracerpython_tpu_torch.kernels.intersect import (
    BIG,
    CLASSIC,
    CULL_GROUP,
    CULL_REACH,
    IMAX,
    PLAIN_CHUNK_ELEMS,
    PLUCKER,
    T_MIN,
    PairTest,
    _scene_derived,
    aabb_cull_rows,
    block_aabbs,
    check_input,
    detach_occlusion,
    nearest_entry,
    resolve_mt_impl,
    scene_cull_boxes,
    scene_plucker_pack,
    scene_tripack,
)
from pathtracerpython_tpu_torch.ops.sort import PARK_DIR, PARK_ORIGIN
from pathtracerpython_tpu_torch.utils.metrics import span

# Scenes from this many padded triangles up resolve accel="auto" to
# AUTO_LARGE, the hybrid: this sparse nearest sweep and the walker any-hit
# (kernels/walker.py) for shadow rays.
SPARSE_MIN_TRIS = 4096
AUTO_LARGE = "hybrid"
C_TRI = 128        # triangles per cluster
PACK_ROWS = 512    # the pack is padded to a multiple of this many rows
R_BLK = 512        # rays per block of accel="sparse"'s sweeps (K5, K6, K7)
R_BLK_HYBRID_NEAREST = 1024  # rays per block of the hybrid's nearest sweep
SLAB_EPS = 1e-3    # conservative slack of every slab comparison
# List slots per unit of the split nearest walks (K5, K3's sparse nearest,
# K8): csrc/cluster.cuh's kSegment, which the kernels are compiled with; of
# the split any-hit walks (K6, K3's sparse any-hit, K9):
# csrc/any_hit_walk.cuh's kAnyHitSegment.
WALK_SEGMENT = 16
ANY_HIT_SEGMENT = 32
# The in-cluster boxes of the any-hit walks (csrc/any_hit_walk.cuh): per
# cluster, spans of SPAN_ROWS rows, mids of MID_ROWS rows and groups of
# CULL_GROUP rows, in that order (csrc/aabb.cuh's levels).
SPAN_ROWS = 32
MID_ROWS = 8
CLUSTER_BOXES = C_TRI // SPAN_ROWS + C_TRI // MID_ROWS + C_TRI // CULL_GROUP
K_GUESS = 8        # voted cached clusters per ray block in K7's pass 1
CACHE_M_DIV = 2    # K7's pass 2 is compacted when it fits n / CACHE_M_DIV
# The two-pass protocol of the uncached sweeps (``two_pass=`` of K5's and
# K6's entries), the JAX package's constants: pass-1 candidate clusters
# per block (sparse_pallas.py:1588, PASS1_K); dropped clusters a lane gets
# its own exact entry for (:403, LANE_M); pass 2 is compacted when it fits
# n / M_DIV lanes (:1604, M_DIV); two_pass=None turns the protocol on only
# from TWO_PASS_MIN lanes (:1605) and only where the sweep's auto flag is
# set (:1589, :1591; off, as there). All are read at every call.
PASS1_K = 4
LANE_M = 8
M_DIV = 2
TWO_PASS_MIN = 32768
TWO_PASS_NEAREST_AUTO = False
TWO_PASS_ANY_AUTO = False

# Launches of the CUDA kernels since the counts were last reset: K5, K6, K7,
# and K3's cluster-sparse nearest and any-hit.
LAUNCHES = 0
ANY_HIT_LAUNCHES = 0
ANY_HIT_IDX_LAUNCHES = 0
PLUCKER_LAUNCHES = 0
PLUCKER_ANY_HIT_LAUNCHES = 0
# Launches of the select-and-compact kernel (csrc/two_pass.cu, each with
# its finish), all three entries: the two finality tests and the compact
# entry of the occluder cache
SELECT_LAUNCHES = 0

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # o3, d3, n
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # tripack, aabb8, C
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ids, keys, ncand
    ctypes.c_int,                                     # r_blk
    ctypes.c_void_p,                                  # words (all ones)
    ctypes.c_void_p, ctypes.c_void_p,                 # t_out, idx_out
    ctypes.c_void_p,                                  # stats (or null)
    ctypes.c_int, ctypes.c_void_p,                    # device, stream
]
# K6, K3's sparse any-hit and K9
_ANY_HIT_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # o3, d3, maxd
    ctypes.c_int,                                       # n
    ctypes.c_void_p, ctypes.c_void_p,                   # tripack, aabb8
    ctypes.c_void_p,                                    # cluster boxes
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ids, keys, ncand
    ctypes.c_int, ctypes.c_int,                         # n_cols, r_blk
    ctypes.c_void_p,                                    # occ (zeroed)
    ctypes.c_void_p,                                    # stats (or null)
    ctypes.c_int, ctypes.c_void_p,                      # device, stream
]
_ANY_HIT_IDX_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # o3, d3, maxd
    ctypes.c_int,                                       # n
    ctypes.c_void_p, ctypes.c_void_p,                   # tripack, aabb8
    ctypes.c_void_p,                                    # cluster boxes
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # ids, keys, ncand
    ctypes.c_int, ctypes.c_int,                         # n_cols, r_blk
    ctypes.c_void_p,                                    # first_slot scratch
    ctypes.c_void_p, ctypes.c_void_p,                   # occ_out, cl_out
    ctypes.c_void_p,                                    # stats (or null)
    ctypes.c_int, ctypes.c_void_p,                      # device, stream
]

# csrc/two_pass.cu's three entries: the pass-1 state (K5's words; K6's
# marks and maxd; the compact entry's flags and maxd), the drops of the two
# finality entries, the slots of pass 2, then the finality test's outputs
_SELECT_DROPS = [
    ctypes.c_void_p, ctypes.c_void_p,                   # aabb8, scene box
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # drop ids, keys, far
    ctypes.c_int, ctypes.c_int,                         # lane_m, r_blk
]
_SELECT_SLOTS = [
    ctypes.c_int, ctypes.c_void_p, ctypes.c_int,        # m, ncand, nrb
    ctypes.c_void_p,                                    # scratch (zeroed)
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # sel, count, taken
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # o2, d2, md2
    ctypes.c_void_p,                                    # ncand_fb (or null)
]
_SELECT_END = [ctypes.c_int, ctypes.c_void_p]           # device, stream
_FLAGS_OUT = [ctypes.c_void_p, ctypes.c_void_p]         # flags, ne (or null)
_NEAREST_SELECT_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,     # o3, d3, n
    ctypes.c_void_p,                                    # words
    *_SELECT_DROPS, *_SELECT_SLOTS, *_FLAGS_OUT, *_SELECT_END,
]
_ANY_HIT_SELECT_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,     # o3, d3, n
    ctypes.c_void_p, ctypes.c_void_p,                   # occ, maxd
    *_SELECT_DROPS, *_SELECT_SLOTS, *_FLAGS_OUT, *_SELECT_END,
]
_COMPACT_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,     # o3, d3, n
    ctypes.c_void_p, ctypes.c_void_p,                   # flags, maxd
    *_SELECT_SLOTS, *_SELECT_END,
]
# lanes a CTA of the select-and-compact kernel covers (csrc/mt.cuh:
# kThreads): its status words are one a tile
SELECT_TILE = 256


def resolve_accel(accel: str, n_padded_tris: int) -> str:
    """The hierarchy ``accel`` selects: "auto" is AUTO_LARGE for scenes of
    SPARSE_MIN_TRIS padded triangles and more, "none" below; other values
    name themselves."""
    if accel == "auto":
        return AUTO_LARGE if n_padded_tris >= SPARSE_MIN_TRIS else "none"
    return accel


def use_sparse(accel: str, n_padded_tris: int) -> bool:
    """Whether the sweeps run a cluster hierarchy: the gate of the
    coherence machinery (wavefront sorting, shadow-lane sorting, relevance
    parking)."""
    return resolve_accel(accel, n_padded_tris) in ("sparse", "walker",
                                                   "hybrid")


class BlockLists(NamedTuple):
    """Per ray block, the candidate clusters in visit order: row b holds
    block b's ``ncand[b]`` clusters and their entry bounds first. The
    width W is the cluster count C for the front-to-back lists, K_GUESS
    for the vote-ordered guess lists (whose bounds are all 0)."""

    ids: torch.Tensor    # i32[nrb, W]
    keys: torch.Tensor   # f32[nrb, W]  conservative entry bound, >= 0
    ncand: torch.Tensor  # i32[nrb]


def pack_for_sparse(scene) -> torch.Tensor:
    """The scene's [T, 12] pack (``scene_tripack``) padded with zero rows
    (not valid) to a multiple of PACK_ROWS, as ``_pack_for_sparse``."""
    tripack = scene_tripack(scene)
    pad = (-tripack.shape[0]) % PACK_ROWS
    if pad:
        tripack = torch.cat([tripack, tripack.new_zeros((pad, 12))])
    return tripack


def cluster_aabbs(tripack: torch.Tensor, c_tri: int = C_TRI) -> torch.Tensor:
    """Per-cluster AABBs f32[C, 8] = (min.xyz | max.xyz | 0 | 0) over the
    valid rows; a cluster without one gets an inverted box."""
    return block_aabbs(tripack, c_tri)


def cluster_cull_boxes(group: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """The boxes of the any-hit walks' in-cluster cull, f32[C, 84, 8]: per
    cluster its C_TRI / SPAN_ROWS span boxes, C_TRI / MID_ROWS mid boxes
    and C_TRI / CULL_GROUP group boxes, in that order. ``group``: the group
    boxes of the dense pack's shadow sweep (``intersect.cull_boxes(...)
    .group``: valid occluder rows, grown); the sparse pack is the dense one
    padded with rows that are not valid, so cluster c's groups are rows
    [64 c, 64 c + 64) of that table, padded with empty (inverted) boxes to
    ``n_clusters`` clusters. A span or mid is the union of its groups, so it
    holds them, grown as they are."""
    per = C_TRI // CULL_GROUP
    empty = group.new_tensor([BIG, BIG, BIG, -BIG, -BIG, -BIG, 0.0, 0.0])
    groups = torch.cat([group, empty.expand(n_clusters * per
                                            - group.shape[0], 8)])
    groups = groups.reshape(n_clusters, per, 8)

    def unions(rows: int) -> torch.Tensor:
        parts = groups.reshape(n_clusters, -1, rows // CULL_GROUP, 8)
        return torch.cat([parts[..., 0:3].amin(dim=2),
                          parts[..., 3:6].amax(dim=2),
                          torch.zeros_like(parts[:, :, 0, 6:])], dim=-1)

    return torch.cat([unions(SPAN_ROWS), unions(MID_ROWS), groups],
                     dim=1).contiguous()


def scene_cluster_cull_boxes(scene) -> torch.Tensor:
    """``cluster_cull_boxes`` of the scene's sparse pack, cached per scene
    beside the dense sweeps' boxes it is made from."""
    def make():
        rows = -(-scene_tripack(scene).shape[0] // PACK_ROWS) * PACK_ROWS
        return cluster_cull_boxes(scene_cull_boxes(scene).group,
                                  rows // C_TRI)

    return _scene_derived(scene, "cluster cull", make)


def pad_repeat_last(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Pad the lane (last) axis to a multiple of ``mult`` by repeating the
    last lane: a block's bounds then cover its real lanes only."""
    pad = (-x.shape[-1]) % mult
    if pad == 0:
        return x
    return torch.cat([x, x[..., -1:].expand(*x.shape[:-1], pad)], dim=-1)


def _interval_inv(x: torch.Tensor) -> torch.Tensor:
    """sign(x) / max(|x|, 1e-12), with sign(0) = 1."""
    sign = torch.sign(torch.where(x == 0.0, 1.0, x))
    return sign / torch.clamp_min(x.abs(), 1e-12)


def candidate_enter_hit(aabb8, o3, d3, tmax_rb, r_blk: int):
    """Interval slab test of every ray block's (origin box x direction
    box) family against every cluster AABB, as ``_candidate_enter_hit``.
    Returns (enter f32[nrb, C] conservative entry bound, hit bool[nrb, C]).
    ``tmax_rb`` f32[nrb]: the block's largest useful distance."""
    o = pad_repeat_last(o3, r_blk)
    d = pad_repeat_last(d3, r_blk)
    nrb = o.shape[1] // r_blk
    o = o.reshape(3, nrb, r_blk)
    d = d.reshape(3, nrb, r_blk)
    olo, ohi = o.amin(dim=2), o.amax(dim=2)   # [3, nrb]
    dlo, dhi = d.amin(dim=2), d.amax(dim=2)
    blo = aabb8[:, 0:3].T                     # [3, C]
    bhi = aabb8[:, 3:6].T
    nonempty = aabb8[:, 0] <= aabb8[:, 3]

    enter = torch.full((nrb, aabb8.shape[0]), -BIG, dtype=o3.dtype,
                       device=o3.device)
    exit_ = torch.full_like(enter, BIG)
    for k in range(3):
        n1 = blo[k][None, :] - ohi[k][:, None]   # [nrb, C]
        n2 = bhi[k][None, :] - olo[k][:, None]
        straddles = ((dlo[k] <= 0.0) & (dhi[k] >= 0.0))[:, None]
        i1 = _interval_inv(dlo[k])[:, None]
        i2 = _interval_inv(dhi[k])[:, None]
        p11, p12, p21, p22 = n1 * i1, n1 * i2, n2 * i1, n2 * i2
        lo_k = torch.minimum(torch.minimum(p11, p12), torch.minimum(p21, p22))
        hi_k = torch.maximum(torch.maximum(p11, p12), torch.maximum(p21, p22))
        lo_k = torch.where(straddles, -BIG, lo_k)
        hi_k = torch.where(straddles, BIG, hi_k)
        enter = torch.maximum(enter, lo_k)
        exit_ = torch.minimum(exit_, hi_k)

    hit = (
        nonempty[None, :]
        & (enter <= exit_ + SLAB_EPS)
        & (exit_ >= -SLAB_EPS)
        & (enter <= tmax_rb[:, None] + SLAB_EPS)
    )
    return enter, hit


def block_lists(aabb8, o3, d3, tmax_rb, r_blk: int) -> BlockLists:
    """Every block's candidate clusters sorted front to back by the clamped
    entry bound (the per-block list of ``grouped_worklist`` and
    ``walker_worklist``, uncapped)."""
    enter, hit = candidate_enter_hit(aabb8, o3, d3, tmax_rb, r_blk)
    key = torch.where(hit, torch.clamp_min(enter, 0.0), BIG)
    keys, order = torch.sort(key, dim=1, stable=True)
    return BlockLists(
        ids=order.to(torch.int32).contiguous(),
        keys=keys.contiguous(),
        ncand=hit.sum(dim=1, dtype=torch.int32),
    )


def window_lists(aabb8, o3, d3_unit, maxd, r_blk: int) -> BlockLists:
    """Every block's candidate clusters within the block's largest shadow
    window ``maxd``, front to back (the any-hit lists of
    ``grouped_worklist`` and ``walker_worklist``, uncapped)."""
    nrb = -(-o3.shape[1] // r_blk)
    tmax = pad_repeat_last(maxd, r_blk).reshape(nrb, r_blk).amax(dim=1)
    return block_lists(aabb8, o3, d3_unit, tmax, r_blk)


def guess_lists(guess_cl: torch.Tensor, n_clusters: int, r_blk: int = R_BLK,
                k_guess: int = K_GUESS) -> BlockLists:
    """Every block's ``k_guess`` most voted cached clusters
    (``guess_worklist``): each lane votes its cached cluster ``guess_cl``
    i32[N]; -1 and out-of-range guesses are dropped, and so are the pad
    lanes of a ragged last block. Vote order, most shared first, ties to
    the smaller cluster id (a stable sort: ``torch.topk`` promises no tie
    order, ``lax.top_k`` this one). An any-hit needs no front-to-back
    order, so every entry bound is 0."""
    n = guess_cl.shape[0]
    nrb = -(-n // r_blk)
    gl = torch.cat([guess_cl, guess_cl.new_full((nrb * r_blk - n,), -1)])
    gl = gl.reshape(nrb, r_blk).to(torch.int64)
    col = torch.where((gl >= 0) & (gl < n_clusters), gl, n_clusters)
    votes = torch.zeros((nrb, n_clusters + 1), dtype=torch.int32,
                        device=guess_cl.device)
    votes.scatter_add_(1, col, torch.ones_like(col, dtype=torch.int32))
    votes = votes[:, :n_clusters]
    k = min(k_guess, n_clusters)
    order = torch.sort(-votes, dim=1, stable=True).indices[:, :k]
    return BlockLists(
        ids=order.to(torch.int32).contiguous(),
        keys=torch.zeros((nrb, k), dtype=torch.float32,
                         device=guess_cl.device),
        ncand=(votes > 0).sum(dim=1, dtype=torch.int32).clamp_max(k),
    )


def lane_slab(box, o, inv):
    """Per-ray slab test of ``_slab_rows_inv``: box [..., 8], o and inv
    [3, ...] broadcast against it. Returns (hit, entry clamped to >= 0)."""
    enter = exit_ = None
    for k in range(3):
        lo = (box[..., k] - o[k]) * inv[k]
        hi = (box[..., k + 3] - o[k]) * inv[k]
        tn, tf = torch.minimum(lo, hi), torch.maximum(lo, hi)
        enter = tn if enter is None else torch.maximum(enter, tn)
        exit_ = tf if exit_ is None else torch.minimum(exit_, tf)
    enter0 = torch.clamp_min(enter, 0.0)
    return exit_ >= enter0 - SLAB_EPS, enter0


def lane_inv(d: torch.Tensor) -> torch.Tensor:
    """1 / d with |d| clamped to 1e-12, sign kept (``_inv_rows``)."""
    tiny = torch.where(d >= 0, 1e-12, -1e-12).to(d.dtype)
    return 1.0 / torch.where(d.abs() < 1e-12, tiny, d)


class BlockRays(NamedTuple):
    """The rays of a wavefront cut into [nrb, 1, r_blk] blocks."""

    o: torch.Tensor     # f32[3, nrb, 1, r_blk]
    d: torch.Tensor     # f32[3, nrb, 1, r_blk]
    inv: torch.Tensor   # f32[3, nrb, 1, r_blk]
    live: torch.Tensor  # bool[nrb, 1, r_blk]  real lanes


def block_rays(o3, d3, nrb: int, r_blk: int) -> BlockRays:
    n = o3.shape[1]
    cut = lambda x: pad_repeat_last(x, r_blk)[..., :nrb * r_blk].reshape(
        x.shape[0], nrb, 1, r_blk)
    d = cut(d3)
    live = torch.arange(nrb * r_blk, device=o3.device) < n
    return BlockRays(cut(o3), d, lane_inv(d), live.reshape(nrb, 1, r_blk))


def cluster_rows(tripack, ids_s: torch.Tensor) -> torch.Tensor:
    """The packed rows [nrb, C_TRI, cols] of cluster ids_s[b] per block."""
    c = tripack.shape[0] // C_TRI
    return tripack.reshape(c, C_TRI, -1)[ids_s.to(torch.int64)]


def by_block_chunks(fn, o3, rows, lists: BlockLists, r_blk: int):
    """``fn(rows_chunk, lists_chunk)`` over runs of whole ray blocks, so
    that a plain walk's [blocks, C_TRI, r_blk] temporaries stay under
    PLAIN_CHUNK_ELEMS elements; ``rows``: per-lane tensors [..., N].
    Returns the per-lane outputs concatenated (a block's list concerns
    its own lanes only, so chunking changes no result)."""
    n = o3.shape[1]
    nrb = lists.ncand.shape[0]
    step = max(1, PLAIN_CHUNK_ELEMS // (C_TRI * r_blk))
    outs = []
    for b0 in range(0, nrb, step):
        lanes = slice(b0 * r_blk, min((b0 + step) * r_blk, n))
        outs.append(fn([x[..., lanes] for x in rows],
                       BlockLists(*(x[b0:b0 + step] for x in lists))))
    return [torch.cat(parts, dim=-1) for parts in zip(*outs)]


def segment_slots(count: int, segment: int | None, order=None):
    """The slot ranges of a walk over lists of at most ``count`` slots, cut
    into segments of ``segment`` slots (None: one segment) and taken in
    ``order``, a sequence of segment numbers (None: front to back; numbers
    past the lists' last segment are skipped)."""
    size = max(count, 1) if segment is None else segment
    n_seg = -(-count // size)
    order = range(n_seg) if order is None else [k for k in order
                                                 if k < n_seg]
    return [range(k * size, min((k + 1) * size, count)) for k in order]


def sparse_nearest_plain(o3, d3_unit, tripack, aabb8, lists: BlockLists,
                         r_blk: int, visits: list | None = None,
                         pair: PairTest = CLASSIC, segment: int | None = None,
                         order=None):
    """The walk of ``csrc/sparse_nearest.cu`` (and of
    ``csrc/walker_nearest.cu``) in PyTorch: slot s of every block's list at
    once, with the kernels' per-lane gate, (t, index) merge and stop (taken
    per block instead of per CTA or warp, which changes no result). Returns
    (t [N] — 0 on a miss, idx [N] int32 — -1 on a miss). ``visits``: a
    list that receives, per chunk and slot, the number of (ray, cluster)
    visits the per-lane gate let through. ``pair``: the form of the
    ray-triangle test, with ``tripack`` in its layout.

    ``segment``: the kernels' split walk, modelled one unit at a time: each
    block's list is cut into segments of ``segment`` slots (None: one
    segment, the serial walk), walked in the ``order`` of their numbers
    (None: front to back; see ``segment_slots``); each segment starts from
    the best that the segments before it in that order merged, with its own
    gate and stop. The merge is a minimum, so every order gives the serial
    walk's result; the visits depend on the order, as the kernels' depend
    on when their units run."""
    def walk(rows, chunk: BlockLists):
        o3c, d3c = rows
        n, nrb = o3c.shape[1], chunk.ncand.shape[0]
        rays = block_rays(o3c, d3c, nrb, r_blk)
        best_t = torch.full((nrb, 1, r_blk), BIG, dtype=o3c.dtype,
                            device=o3c.device)
        best_idx = torch.full((nrb, 1, r_blk), -1, dtype=torch.int32,
                              device=o3c.device)
        for slots in segment_slots(int(chunk.ncand.max()), segment, order):
            walking = torch.ones(nrb, dtype=torch.bool, device=o3c.device)
            for s in slots:
                walking = _nearest_slot(s, chunk, rays, walking, best_t,
                                        best_idx, tripack, aabb8, visits,
                                        pair)
                if walking is None:
                    break
        return best_t.reshape(-1)[:n], best_idx.reshape(-1)[:n]

    t, idx = by_block_chunks(walk, o3, [o3, d3_unit], lists, r_blk)
    return torch.where(idx >= 0, t, 0.0), idx


def walk_visit_band(o3, d3_unit, tripack, aabb8, lists: BlockLists,
                    r_blk: int, t, idx, segment: int,
                    pair: PairTest = CLASSIC) -> tuple[int, int]:
    """The band of (ray, cluster) visits of a split nearest walk in
    segments of ``segment`` slots whose winners are (t, idx), in any order
    and at any timing of its units. Floor: per lane the clusters of its
    block's list whose slab test it passes with entry < its winner's t +
    SLAB_EPS (the whole ray where it misses); a lane's bound never falls
    below its winner, so every walk visits them. Ceiling: the visits of the
    segments when each starts from nothing; a unit that reads a merged best
    only gates tighter. Returns (floor, ceiling)."""
    nrb = lists.ncand.shape[0]
    rays = block_rays(o3, d3_unit, nrb, r_blk)
    reach = pad_repeat_last(torch.where(idx >= 0, t, BIG), r_blk)[
        :nrb * r_blk].reshape(nrb, 1, r_blk)
    floor = 0
    for s in range(int(lists.ncand.max())):
        box = aabb8[lists.ids[:, s].to(torch.int64)][:, None, None, :]
        slab, enter0 = lane_slab(box, rays.o, rays.inv)
        floor += int(((s < lists.ncand)[:, None, None] & rays.live & slab
                      & (enter0 < reach + SLAB_EPS)).sum())
    ceiling = 0
    for lo in range(0, int(lists.ncand.max()), segment):
        part = BlockLists(lists.ids[:, lo:], lists.keys[:, lo:],
                          (lists.ncand - lo).clamp(0, segment))
        visits = []
        sparse_nearest_plain(o3, d3_unit, tripack, aabb8, part, r_blk, visits,
                             pair)
        ceiling += int(sum(int(v) for v in visits))
    return floor, ceiling


def _nearest_slot(s, chunk, rays, walking, best_t, best_idx, tripack, aabb8,
                  visits, pair):
    """Slot ``s`` of every block's list: the stop, the per-lane gate and
    the (t, index) merge into ``best_t`` / ``best_idx`` in place. Returns
    the blocks still walking, or None when none is."""
    key = chunk.keys[:, s][:, None, None]
    walking = walking & (s < chunk.ncand) & (
        rays.live & (key <= best_t + SLAB_EPS)).flatten(1).any(dim=1)
    if not bool(walking.any()):
        return None
    cl = chunk.ids[:, s]
    box = aabb8[cl.to(torch.int64)][:, None, None, :]
    slab, enter0 = lane_slab(box, rays.o, rays.inv)
    needed = (walking[:, None, None] & rays.live & slab
              & (enter0 < best_t + SLAB_EPS))
    if visits is not None:
        visits.append(needed.sum())
    hit, t = pair.rows(cluster_rows(tripack, cl), *rays.o, *rays.d)
    tkey = torch.where(hit, t, BIG)             # [nrb, C_TRI, r_blk]
    tile_t = tkey.amin(dim=1, keepdim=True)
    gidx = (cl[:, None, None] * C_TRI
            + torch.arange(C_TRI, dtype=torch.int32,
                           device=cl.device)[None, :, None])
    cand = torch.where((tkey == tile_t) & hit, gidx, IMAX)
    tile_idx = cand.amin(dim=1, keepdim=True)
    better = needed & (tile_idx != IMAX) & (
        (tile_t < best_t) | ((tile_t == best_t) & (tile_idx < best_idx)))
    best_t.copy_(torch.where(better, tile_t, best_t))
    best_idx.copy_(torch.where(better, tile_idx, best_idx))
    return walking


def any_hit_walk(o3, d3_unit, maxd, tripack, aabb8, lists: BlockLists,
                 r_blk: int, visits: list | None = None,
                 pair: PairTest = CLASSIC, cull: torch.Tensor | None = None,
                 segment: int | None = None, order=None,
                 counts: dict | None = None, merge: str = "mark"):
    """The any-hit walk of the cluster shadow sweeps in PyTorch: slot s of
    every block's list at once, with the kernels' per-lane gate, first-hit
    stop and whole-walk stop (taken per block, which changes no result).
    Returns (occlusion bool[N], the first blocking cluster in the walk's
    visit order i32[N], -1 where not occluded). ``visits`` and ``pair``: as
    in ``sparse_nearest_plain``.

    Without ``cull`` a lane tests every valid occluder row of a cluster it
    visits, in row order up to its first blocking one: the serial walk of
    ``csrc/sparse_any_hit_idx.cu`` (K7), and the oracle of the others.
    ``cull``: the boxes of ``cluster_cull_boxes``; a lane then tests only
    the rows under the span, mid and group boxes it meets up to maxd *
    CULL_REACH (``aabb_cull_rows``), which is the walk of
    ``csrc/any_hit_walk.cuh`` (K6, K3's sparse any-hit, K9, K7).

    ``segment``: that walk's units, modelled one at a time: each block's
    list is cut into segments of ``segment`` slots (None: one segment, the
    serial walk), walked in the ``order`` of their numbers (see
    ``segment_slots``), each with its own gate and stop. A lane's first
    blocking slot is the smallest that a segment found; the cluster
    returned is that slot's. ``merge`` says which lanes a segment starts
    with. "mark" (K6, K9: the occlusion marks a unit reads): those that
    the segments before it in that order left unblocked. "first_slot" (K7:
    the first blocking slot a unit reads): those whose first blocking slot
    among the segments before it is not below the segment's first slot.
    Occlusion is an OR over the slots, so every order gives the same bits
    under either merge, and under "first_slot" the same clusters; under
    "mark" a later segment walked first names its own, later cluster. The
    visits depend on the order, as the kernels' depend on when their units
    run.

    ``counts``: a dict whose entries "visits", "pairs_tested" and, with
    ``cull``, "span_tests", "mid_tests" and "group_tests" receive what the
    kernels' counting instance counts for this walk."""
    if merge not in ("mark", "first_slot"):
        raise ValueError(f"merge must be 'mark' or 'first_slot', not "
                         f"{merge!r}")

    def walk(rows, chunk: BlockLists):
        o3c, d3c, mdc = rows
        n, nrb = o3c.shape[1], chunk.ncand.shape[0]
        rays = block_rays(o3c, d3c, nrb, r_blk)
        md = pad_repeat_last(mdc, r_blk).reshape(nrb, 1, r_blk)
        t_cut = md - T_MIN
        can = rays.live & (t_cut > T_MIN)   # a blocking hit is possible
        # each lane's first blocking slot (IMAX: none) and its cluster
        first = torch.full((nrb, 1, r_blk), IMAX, dtype=torch.int64,
                           device=o3c.device)
        blocked = torch.full((nrb, 1, r_blk), -1, dtype=torch.int32,
                             device=o3c.device)
        for slots in segment_slots(int(chunk.ncand.max()), segment, order):
            # the lanes the unit starts with, by the word it reads
            unit_open = can & ((first == IMAX) if merge == "mark"
                               else (first >= slots.start))
            walking = torch.ones(nrb, dtype=torch.bool, device=o3c.device)
            for s in slots:
                key = chunk.keys[:, s][:, None, None]
                walking = walking & (s < chunk.ncand) & (
                    unit_open & (key <= md + SLAB_EPS)).flatten(1).any(dim=1)
                if not bool(walking.any()):
                    break
                cl = chunk.ids[:, s]
                box = aabb8[cl.to(torch.int64)][:, None, None, :]
                slab, enter0 = lane_slab(box, rays.o, rays.inv)
                needed = (walking[:, None, None] & unit_open & slab
                          & (enter0 < md + SLAB_EPS))
                if visits is not None:
                    visits.append(needed.sum())
                newly = _any_hit_visit(cluster_rows(tripack, cl), cl, rays,
                                       md, needed, pair, cull, counts)
                # an open lane's first slot is none or a later segment's
                first = torch.where(newly, s, first)
                blocked = torch.where(newly, cl[:, None, None], blocked)
                unit_open = unit_open & ~newly
        return [(first != IMAX).reshape(-1)[:n], blocked.reshape(-1)[:n]]

    return by_block_chunks(walk, o3, [o3, d3_unit, maxd], lists, r_blk)


def _any_hit_visit(tri, cl, rays, md, needed, pair, cull, counts):
    """One slot of every block: the lanes ``needed`` bool[nrb, 1, r_blk]
    test the rows ``tri`` [nrb, C_TRI, cols] of clusters ``cl``, culled by
    the clusters' boxes in ``cull`` (or not, for None). Returns the lanes
    that a row blocks; adds the visit's counts to ``counts``."""
    hit, t = pair.rows(tri, *rays.o, *rays.d)       # [nrb, C_TRI, r_blk]
    flag = lambda c: tri[..., c:c + 1] > 0.5
    tested = flag(pair.valid_col) & flag(pair.occluder_col)
    if cull is not None:
        boxes = cull[cl.to(torch.int64)]            # [nrb, 84, 8]
        bound = md * CULL_REACH
        spans, mids = C_TRI // SPAN_ROWS, C_TRI // MID_ROWS

        def met(lo: int, hi: int) -> torch.Tensor:
            hit_b, nonempty = aabb_cull_rows(boxes[:, lo:hi], list(rays.o),
                                             list(rays.d), bound)
            return hit_b & nonempty                 # [nrb, hi - lo, r_blk]

        # a box is tested where the box above it is met (the warp's votes
        # let a lane through only under a box it meets itself)
        span = met(0, spans)
        mid = met(spans, spans + mids) & span.repeat_interleave(
            SPAN_ROWS // MID_ROWS, dim=1)
        group = met(spans + mids, CLUSTER_BOXES) & mid.repeat_interleave(
            MID_ROWS // CULL_GROUP, dim=1)
        tested = tested & group.repeat_interleave(CULL_GROUP, dim=1)
    blocking = tested & hit & (t < md - T_MIN)
    if counts is not None:
        # a lane reaches the rows up to its first blocking one, and a box
        # whose first row it reaches
        first = torch.where(blocking, _row_index(tri.device, 1), C_TRI).amin(
            dim=1, keepdim=True)
        reached = lambda step: _row_index(tri.device, step) <= first
        _add(counts, "visits", needed)
        _add(counts, "pairs_tested", needed & tested & reached(1))
        if cull is not None:
            _add(counts, "span_tests", needed & reached(SPAN_ROWS))
            _add(counts, "mid_tests", needed & reached(MID_ROWS)
                 & span.repeat_interleave(SPAN_ROWS // MID_ROWS, dim=1))
            _add(counts, "group_tests", needed & reached(CULL_GROUP)
                 & mid.repeat_interleave(MID_ROWS // CULL_GROUP, dim=1))
    return needed & blocking.any(dim=1, keepdim=True)


def _row_index(device, step: int) -> torch.Tensor:
    """The first row of each box of ``step`` rows of a cluster, [1, K, 1]."""
    return torch.arange(0, C_TRI, step, device=device)[None, :, None]


def _add(counts: dict, key: str, mask: torch.Tensor) -> None:
    counts[key] = counts.get(key, 0) + int(mask.sum())


# What the counting instance of a split any-hit walk (K6, K3's sparse
# any-hit, K9, K7) counts, in the order of its counters
# (csrc/cluster.cuh: WalkCounter, csrc/any_hit_walk.cuh: AnyHitCounter).
ANY_HIT_COUNTS = ("units_launched", "units_stopped_at_once", "visits",
                  "span_tests", "mid_tests", "group_tests", "pairs_tested")


def any_hit_stats(stats: torch.Tensor) -> dict:
    """What the counting instance of a split any-hit walk added to
    ``stats`` i64[7] in one launch: units launched (CTAs with list slots),
    units that stopped before their first slot, (lane, cluster) visits
    through the per-lane gate, box tests of the span, mid and group levels
    (a lane's test of one box), and pairs tested."""
    return dict(zip(ANY_HIT_COUNTS, stats.tolist()))


def any_hit_floor(o3, d3_unit, maxd, tripack, aabb8, lists: BlockLists,
                  r_blk: int, occ, pair: PairTest = CLASSIC,
                  cull: torch.Tensor | None = None) -> dict:
    """What every split any-hit walk whose bits are ``occ`` counts, in any
    order and at any timing of its units: "visits" and "pairs_tested". A
    lane that ends unoccluded is tested on every cluster of its list that
    its gate lets through (no mark ever stops it), as the serial walk tests
    it; an occluded lane is visited and tested at least once."""
    counts: dict = {}
    any_hit_walk(o3, d3_unit, torch.where(occ, 0.0, maxd), tripack, aabb8,
                 lists, r_blk, pair=pair, cull=cull, counts=counts)
    blocked = int(occ.sum())
    return {key: counts.get(key, 0) + blocked
            for key in ("visits", "pairs_tested")}


def any_hit_visit_band(o3, d3_unit, maxd, tripack, aabb8, lists: BlockLists,
                       r_blk: int, occ, segment: int,
                       pair: PairTest = CLASSIC,
                       cull: torch.Tensor | None = None) -> dict:
    """The band of the counts (``any_hit_walk``'s ``counts``) of a split
    any-hit walk in segments of ``segment`` slots whose bits are ``occ``,
    in any order and at any timing of its units: {name: (floor, ceiling)}.
    Floor: ``any_hit_floor`` for visits and pairs, 0 for the box tests.
    Ceiling: the counts of the segments when each starts with every lane
    open; a unit that reads a mark only drops a lane sooner, and a visit's
    tests depend on the lane and the cluster alone."""
    floor = any_hit_floor(o3, d3_unit, maxd, tripack, aabb8, lists, r_blk,
                          occ, pair, cull)
    ceiling: dict = {}
    for lo in range(0, int(lists.ncand.max()), segment):
        part = BlockLists(lists.ids[:, lo:], lists.keys[:, lo:],
                          (lists.ncand - lo).clamp(0, segment))
        any_hit_walk(o3, d3_unit, maxd, tripack, aabb8, part, r_blk,
                     pair=pair, cull=cull, counts=ceiling)
    return {key: (floor.get(key, 0), value)
            for key, value in ceiling.items()}


def sparse_any_hit_plain(o3, d3_unit, maxd, tripack, aabb8,
                         lists: BlockLists, r_blk: int,
                         visits: list | None = None,
                         pair: PairTest = CLASSIC) -> torch.Tensor:
    """K6's plain version: occlusion bool[N] by ``any_hit_walk``, the
    serial un-culled walk. The kernel walks a block's list in units on many
    CTAs and culls inside a cluster; occlusion is an OR over the slots and
    the cull drops no conditioned hit, so the walk gives the same bits."""
    return any_hit_walk(o3, d3_unit, maxd, tripack, aabb8, lists, r_blk,
                        visits, pair)[0]


def sparse_nearest_plucker_plain(o3, d3_unit, pack36, aabb8,
                                 lists: BlockLists, r_blk: int,
                                 visits: list | None = None):
    """K3's cluster-sparse nearest sweep, plain: ``sparse_nearest_plain``'s
    walk with the Plücker test on a ``plucker_pack``."""
    return sparse_nearest_plain(o3, d3_unit, pack36, aabb8, lists, r_blk,
                                visits, PLUCKER)


def sparse_any_hit_plucker_plain(o3, d3_unit, maxd, pack36, aabb8,
                                 lists: BlockLists, r_blk: int,
                                 visits: list | None = None) -> torch.Tensor:
    """K3's cluster-sparse any-hit, plain: ``sparse_any_hit_plain``'s walk
    with the Plücker test on a ``plucker_pack``."""
    return sparse_any_hit_plain(o3, d3_unit, maxd, pack36, aabb8, lists,
                                r_blk, visits, PLUCKER)


def sparse_any_hit_idx_plain(o3, d3_unit, maxd, tripack, aabb8,
                             lists: BlockLists, r_blk: int,
                             visits: list | None = None):
    """K7's plain version: (occlusion bool[N], first blocking cluster in
    visit order i32[N], -1 where not occluded) by ``any_hit_walk``, the
    serial un-culled walk. The kernel walks a block's list in units on many
    CTAs, merged by each lane's first blocking slot, and culls inside a
    cluster; it gives the bits of this walk, and its clusters wherever no
    pair test is ill-conditioned (its own model is ``any_hit_walk(...,
    cull=, merge="first_slot")``)."""
    return any_hit_walk(o3, d3_unit, maxd, tripack, aabb8, lists, r_blk,
                        visits)


def check_rays(o3, d3_unit, scene, what: str, maxd=None):
    """Check the ray inputs of a sweep; returns (n, tripack, aabb8)."""
    device = o3.device
    n = o3.shape[1] if o3.dim() == 2 else -1
    check_input("o3", o3, device, torch.float32, (3, None))
    check_input("d3_unit", d3_unit, device, torch.float32, (3, n))
    if maxd is not None:
        check_input("maxd", maxd, device, torch.float32, (n,))
    tripack = pack_for_sparse(scene)
    check_input("scene triangles", tripack, device, torch.float32, (None, 12))
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {device}")
    return n, tripack, cluster_aabbs(tripack)


def sparse_nearest_t_idx_cm(o3: torch.Tensor, d3_unit: torch.Tensor, scene,
                            r_blk: int = R_BLK, mt_impl: str | None = None,
                            two_pass: int | None = None, m_div: int = M_DIV):
    """Closest forward hit of rays o3/d3_unit f32[3, N] (d3_unit of unit
    length) through the cluster hierarchy, in blocks of ``r_blk`` rays
    (the sparse hierarchy's R_BLK; the hybrid passes
    R_BLK_HYBRID_NEAREST); the result of the dense ``nearest_t_idx_cm`` in
    the same form ``mt_impl`` (None: ``intersect.MT_IMPL``), bit for bit:
    (t [N] — 0 on a miss, idx [N] int32 — -1 on a miss); its gradients
    too (``intersect.nearest_entry``: one re-solve over the whole
    wavefront, whatever the passes).

    ``two_pass``: pass-1 candidate clusters per block of the two-pass
    protocol (``two_pass_nearest``), 0 for one pass, None for
    ``resolve_two_pass`` with TWO_PASS_NEAREST_AUTO; ``m_div``: pass 2 is
    compacted when its lanes fit ``pass2_size(N, r_blk, m_div)``. The
    result is the one-pass result bit for bit either way."""
    return nearest_entry(
        lambda o, d, sc: _sparse_nearest_t_idx(o, d, sc, r_blk, mt_impl,
                                               two_pass, m_div),
        o3, d3_unit, scene)


def _sparse_nearest_t_idx(o3, d3_unit, scene, r_blk, mt_impl, two_pass,
                          m_div):
    plucker = resolve_mt_impl(mt_impl) == "plucker"
    device = o3.device
    n, tripack, aabb8 = check_rays(o3, d3_unit, scene, "sparse nearest-hit")
    if n == 0:
        return (torch.zeros(0, dtype=o3.dtype, device=device),
                torch.zeros(0, dtype=torch.int32, device=device))
    nrb = -(-n // r_blk)
    tmax = torch.full((nrb,), BIG, dtype=o3.dtype, device=device)
    lists = block_lists(aabb8, o3, d3_unit, tmax, r_blk)
    # under "plucker" the clusters and their boxes are the classic pack's;
    # only the rows a ray is tested against change
    pack = scene_plucker_pack(scene, PACK_ROWS) if plucker else tripack
    if device.type == "cpu":
        plain = sparse_nearest_plucker_plain if plucker else \
            sparse_nearest_plain
        sweep = lambda o, d, li, words=None: plain(o, d, pack, aabb8, li,
                                                    r_blk)
    else:
        launch = _launch_plucker if plucker else _launch
        sweep = lambda o, d, li, words=None: launch(o, d, pack, aabb8, li,
                                                     r_blk, words=words)
    k = resolve_two_pass(two_pass, n, TWO_PASS_NEAREST_AUTO)
    if k == 0:
        return sweep(o3, d3_unit, lists)
    return two_pass_nearest(sweep, o3, d3_unit, aabb8,
                            scene_cluster_box(scene), lists, r_blk, k, m_div)


def sparse_any_hit_cm(o3: torch.Tensor, d3_unit: torch.Tensor,
                      maxd: torch.Tensor, scene,
                      mt_impl: str | None = None,
                      two_pass: int | None = None,
                      m_div: int = M_DIV) -> torch.Tensor:
    """K6: whether an occluder triangle blocks each shadow ray o3/d3_unit
    f32[3, N] (d3_unit of unit length) at t < maxd - 1e-4, through the
    cluster hierarchy in blocks of R_BLK rays; bool[N], the result of the
    dense ``any_hit_cm`` in the same form ``mt_impl`` (None:
    ``intersect.MT_IMPL``). Lanes with maxd = 0 (parked) are never
    occluded. The cached any-hit K7 (``sparse_any_hit_cached_cm``) has no
    Plücker form and stays classic under the knob, as in the JAX
    package. ``two_pass`` and ``m_div``: as in
    ``sparse_nearest_t_idx_cm`` (``two_pass_any_hit``; None reads
    TWO_PASS_ANY_AUTO); the bits are the one-pass bits either way."""
    o3, d3_unit, maxd, scene = detach_occlusion(o3, d3_unit, maxd, scene)
    plucker = resolve_mt_impl(mt_impl) == "plucker"
    n, tripack, aabb8 = check_rays(o3, d3_unit, scene, "sparse any-hit",
                                    maxd)
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=o3.device)
    lists = window_lists(aabb8, o3, d3_unit, maxd, R_BLK)
    pack = scene_plucker_pack(scene, PACK_ROWS) if plucker else tripack
    if o3.device.type == "cpu":
        plain = (sparse_any_hit_plucker_plain if plucker
                 else sparse_any_hit_plain)
        sweep = lambda o, d, md, li: plain(o, d, md, pack, aabb8, li, R_BLK)
    else:
        # the clusters, their boxes and the lists are the classic pack's;
        # only the rows a ray is tested against change with the form
        launch = _launch_plucker_any_hit if plucker else _launch_any_hit
        cull = scene_cluster_cull_boxes(scene)
        sweep = lambda o, d, md, li: launch(o, d, md, pack, aabb8, li, R_BLK,
                                            cull)
    k = resolve_two_pass(two_pass, n, TWO_PASS_ANY_AUTO)
    if k == 0:
        return sweep(o3, d3_unit, maxd, lists)
    return two_pass_any_hit(sweep, o3, d3_unit, maxd, aabb8,
                            scene_cluster_box(scene), lists, k, m_div)


def pass2_size(n: int, r_blk: int = R_BLK, m_div: int = CACHE_M_DIV) -> int:
    """Lanes of a compacted pass 2 (K7's, and the two-pass protocol's) for
    a wavefront of ``n``: n / m_div, at least one block, in whole blocks
    (``_pass2_size`` on the wavefront padded to whole blocks)."""
    n_pad = -(-n // r_blk) * r_blk
    m = max(r_blk, -(-n_pad // m_div))
    return -(-m // r_blk) * r_blk


# ---------------------------------------------------------------------------
# The two-pass protocol of the uncached sweeps (the JAX package's
# ``two_pass`` of ``sparse_nearest_t_idx_cm`` and ``sparse_any_hit_cm``,
# sparse_pallas.py:1968-2014, :2103-2137). Pass 1 walks the first k slots
# of each block's list (K5, K6 or K3's sparse sweeps, unchanged: they walk
# ``ncand`` slots). The select-and-compact kernel (csrc/two_pass.cu; plain
# twins ``two_pass_flags_plain`` and ``select_compact_plain``) bounds from
# below, per lane, the entry of every cluster pass 1 dropped; a lane whose
# pass-1 result that bound cannot change is final. The rest are compacted
# into ``pass2_size`` slots (the tail parked), which pass 2 sweeps over the
# full lists of their new blocks; where they do not fit, the whole
# wavefront is swept again in one pass. The per-lane gate of the walks is
# conservative by SLAB_EPS, and so is the finality test, so the result is
# the one-pass result bit for bit.
#
# The branch is chosen on the device, as the JAX package's ``lax.cond``
# chooses it: the kernel writes the count, the slots and a ``taken`` word;
# pass 2 always runs over its m slots (all parked when taken, so its lists
# are empty), and so does the fallback over the full lists with the counts
# ``ncand_fb`` (all 0 unless taken, so its units exit at once); ``taken``
# picks one of the two. Nothing is read back to the host.


class Drops(NamedTuple):
    """What a truncated pass dropped, per ray block: its first LANE_M
    dropped list slots (ids, and keys: the block's entry bound, BIG where a
    slot names no candidate) and ``far``, the key of the slot after them
    (BIG when the list ends there)."""

    ids: torch.Tensor    # i32[nrb, m]
    keys: torch.Tensor   # f32[nrb, m]
    far: torch.Tensor    # f32[nrb]


def resolve_two_pass(two_pass: int | None, n: int, default_on: bool) -> int:
    """Pass-1 candidate clusters per block (0: one pass), as
    ``_resolve_two_pass``: None is PASS1_K for wavefronts of TWO_PASS_MIN
    lanes and more where ``default_on`` (the sweep's auto flag), else 0."""
    if two_pass is None:
        return PASS1_K if default_on and n >= TWO_PASS_MIN else 0
    if int(two_pass) < 0:
        raise ValueError(f"two_pass must be >= 0 or None, not {two_pass}")
    return int(two_pass)


def truncate_lists(lists: BlockLists, k: int) -> tuple[BlockLists, Drops]:
    """The first ``k`` slots of every block's front-to-back list (the
    lists ``candidate_worklist(..., trunc_k=k)`` keeps; a narrower list of
    the same format, so the walks need nothing new), and what they drop:
    the next LANE_M slots and the key after them."""
    c = lists.ids.shape[1]
    lo, hi = min(k, c), min(k + LANE_M, c)
    head = BlockLists(lists.ids[:, :lo].contiguous(),
                      lists.keys[:, :lo].contiguous(),
                      lists.ncand.clamp_max(k))
    far = (lists.keys[:, hi].contiguous() if hi < c else
           torch.full_like(lists.ncand, BIG, dtype=lists.keys.dtype))
    return head, Drops(lists.ids[:, lo:hi].contiguous(),
                       lists.keys[:, lo:hi].contiguous(), far)


def lane_slab_enter_exit(o3, d3, blo, bhi):
    """Exact per-lane slab interval, ``_lane_slab_enter_exit``: ``o3`` /
    ``d3`` [3, *ray-shape], ``blo`` / ``bhi`` [3, *box-shape], broadcast
    against each other past the leading axis; the reciprocal's |d| clamped
    to 1e-12. Returns (enter, exit), not clamped."""
    inv = lane_inv(d3)
    enter = exit_ = None
    for k in range(3):
        lo = (blo[k] - o3[k]) * inv[k]
        hi = (bhi[k] - o3[k]) * inv[k]
        tn, tf = torch.minimum(lo, hi), torch.maximum(lo, hi)
        enter = tn if enter is None else torch.maximum(enter, tn)
        exit_ = tf if exit_ is None else torch.minimum(exit_, tf)
    return enter, exit_


def lane_unseen_bound(o3, d3_unit, aabb8, drops: Drops,
                      r_blk: int) -> torch.Tensor:
    """Per lane, a lower bound f32[N] on the entry of every cluster its
    block's truncated list dropped (``_lane_unseen_bound``): the lane's own
    slab entry, clamped to >= 0, into each of the ``drops`` it hits (a miss
    bounds nothing), and ``drops.far`` beyond them; BIG when nothing was
    dropped."""
    n = o3.shape[1]
    nrb, m = drops.ids.shape
    cut = lambda x: pad_repeat_last(x, r_blk).reshape(3, nrb, 1, r_blk)
    boxes = aabb8[drops.ids.to(torch.int64)]              # [nrb, m, 8]
    blo = boxes[..., 0:3].movedim(-1, 0)[..., None]       # [3, nrb, m, 1]
    bhi = boxes[..., 3:6].movedim(-1, 0)[..., None]
    enter, exit_ = lane_slab_enter_exit(cut(o3), cut(d3_unit), blo, bhi)
    enter0 = torch.clamp_min(enter, 0.0)                  # [nrb, m, r_blk]
    seen = (exit_ >= enter0 - SLAB_EPS) & (drops.keys < BIG)[:, :, None]
    lane = torch.where(seen, enter0, BIG)
    bound = lane.amin(dim=1) if m else torch.full(
        (nrb, r_blk), BIG, dtype=o3.dtype, device=o3.device)
    return torch.minimum(bound, drops.far[:, None]).reshape(-1)[:n]


def scene_box(aabb8: torch.Tensor) -> torch.Tensor:
    """The box of every non-empty cluster box, f32[8] (min.xyz | max.xyz |
    0 | 0; inverted where every cluster is empty)."""
    nonempty = (aabb8[:, 0] <= aabb8[:, 3])[:, None]
    lo = torch.where(nonempty, aabb8[:, 0:3], BIG).amin(dim=0)
    hi = torch.where(nonempty, aabb8[:, 3:6], -BIG).amax(dim=0)
    return torch.cat([lo, hi, lo.new_zeros(2)])


def scene_cluster_box(scene) -> torch.Tensor:
    """``scene_box`` of the scene's sparse pack's cluster boxes, cached per
    scene beside ``scene_cluster_cull_boxes``: the two-pass sweeps pass it
    to the finality test, so no call reduces the boxes again."""
    return _scene_derived(scene, "cluster box", lambda: scene_box(
        cluster_aabbs(pack_for_sparse(scene))))


def two_pass_flags_plain(o3, d3_unit, aabb8, drops: Drops, r_blk: int,
                         reach: torch.Tensor,
                         open_: torch.Tensor | None = None,
                         box: torch.Tensor | None = None):
    """The finality test of csrc/two_pass.cu in PyTorch: a lane is
    unfinished where it is ``open_`` (None: every lane), its ray meets
    ``box`` (None: ``scene_box(aabb8)``; a ray that misses it misses every
    cluster: a parked lane or one leaving the scene is final) and
    ``lane_unseen_bound`` < ``reach`` + SLAB_EPS. ``reach``: the nearest
    sweep's pass-1 t (BIG on a miss), or the any-hit's maxd with ``open_``
    its unblocked lanes that can be blocked at all. Returns (unfinished
    bool[N], the bound f32[N])."""
    ne = lane_unseen_bound(o3, d3_unit, aabb8, drops, r_blk)
    box = scene_box(aabb8) if box is None else box
    meets, _ = lane_slab(box, o3, lane_inv(d3_unit))
    unfinished = meets & (ne < reach + SLAB_EPS)
    if open_ is not None:
        unfinished = unfinished & open_
    return unfinished, ne


def any_hit_open(occ: torch.Tensor, maxd: torch.Tensor) -> torch.Tensor:
    """The any-hit lanes pass 1 left open: not blocked, and blockable at
    all (the walks' gate: maxd - T_MIN > T_MIN; parked lanes have maxd
    0)."""
    return ~occ & (maxd - T_MIN > T_MIN)


class Selection(NamedTuple):
    """What the select-and-compact kernel (csrc/two_pass.cu) or its plain
    twin gives for a wavefront of N lanes and a pass 2 of m slots."""

    sel: torch.Tensor      # i64[m] slot s: the s-th unfinished lane; N
    #                        past the count, and everywhere when taken
    count: torch.Tensor    # i32[1] the unfinished lanes
    taken: torch.Tensor    # bool[1] count > m: the fallback's branch
    rays: tuple            # pass 2's (o2, d2) f32[3, m] and, with maxd,
    #                        md2 f32[m]; a slot with sel N is parked at
    #                        PARK_ORIGIN / PARK_DIR with window 1
    ncand_fb: torch.Tensor | None  # i32[nrb] the full lists' counts where
    #                                taken, else 0 (None: none given)
    flags: torch.Tensor | None = None  # bool[N] unfinished, where asked
    ne: torch.Tensor | None = None     # f32[N] the finality bound, asked


def select_compact_plain(unfinished: torch.Tensor, m: int, o3, d3_unit,
                         maxd: torch.Tensor | None = None,
                         ncand: torch.Tensor | None = None) -> Selection:
    """The compaction and the finish of csrc/two_pass.cu in PyTorch, as the
    JAX package has them: ``_compact_select`` (a cumsum; the s-th
    unfinished lane to slot s while s < m), ``_gather_parked`` (the slots'
    rays, the rest parked) and the branch of ``lax.cond`` (count <= m),
    decided on the tensors, never on the host. Where the count exceeds m,
    every slot is parked and ``ncand_fb`` is ``ncand`` (else 0)."""
    n = unfinished.shape[0]
    device = unfinished.device
    pos = torch.cumsum(unfinished.to(torch.int64), 0) - 1
    count = unfinished.sum(dtype=torch.int32).reshape(1)
    taken = count > m
    slot = torch.where(unfinished & (pos < m) & ~taken, pos, m)
    sel = torch.full((m + 1,), n, dtype=torch.int64, device=device)
    sel = sel.scatter(0, slot, torch.arange(n, device=device))[:m]
    valid = sel < n
    lane = sel.clamp_max(n - 1)
    park = lambda at: o3.new_tensor(at)[:, None]
    rays = (torch.where(valid, o3[:, lane], park(PARK_ORIGIN)),
            torch.where(valid, d3_unit[:, lane], park(PARK_DIR)))
    if maxd is not None:
        rays += (torch.where(valid, maxd[lane], 1.0),)
    ncand_fb = None if ncand is None else torch.where(taken, ncand, 0)
    return Selection(sel, count, taken, rays, ncand_fb)


def scatter_back(dst: torch.Tensor, sel: torch.Tensor,
                 src: torch.Tensor) -> torch.Tensor:
    """``_scatter_back``: ``dst`` [N] with ``src[s]`` written at lane
    ``sel[s]`` for every slot s; the sentinel N drops a slot (``mode=
    "drop"``), through a buffer of N + 1 lanes whose last is the
    sentinel's."""
    n = dst.shape[0]
    return torch.cat([dst, dst[:1]]).index_copy_(0, sel, src)[:n]


def nearest_select(o3, d3_unit, aabb8, drops: Drops, r_blk: int, t, idx,
                   words: torch.Tensor | None = None, want_ne: bool = False,
                   box: torch.Tensor | None = None):
    """The finality test of the nearest sweep's pass 1 (t, idx) alone:
    ``nearest_select_compact`` into one slot, which nothing reads (on the
    card it reads pass 1's merged ``words``, K5's scratch).
    ``box``: the scene's box (None: ``scene_box(aabb8)``). Returns
    (unfinished bool[N], the bound f32[N] where ``want_ne``, else None)."""
    s = nearest_select_compact(o3, d3_unit, aabb8,
                               scene_box(aabb8) if box is None else box,
                               drops, r_blk, t, idx, words, 1,
                               want_flags=True, want_ne=want_ne)
    return s.flags, s.ne


def any_hit_select(o3, d3_unit, maxd, occ, aabb8, drops: Drops, r_blk: int,
                   want_ne: bool = False, box: torch.Tensor | None = None):
    """The finality test of the any-hit's pass 1 ``occ`` alone:
    ``any_hit_select_compact`` into one slot; the arguments as
    ``nearest_select``'s. Returns (unfinished bool[N], the bound f32[N]
    where ``want_ne``, else None)."""
    s = any_hit_select_compact(o3, d3_unit, maxd, occ, aabb8,
                               scene_box(aabb8) if box is None else box,
                               drops, r_blk, 1, want_flags=True,
                               want_ne=want_ne)
    return s.flags, s.ne


def nearest_select_compact(o3, d3_unit, aabb8, box, drops: Drops,
                           r_blk: int, t, idx, words, m: int,
                           ncand: torch.Tensor | None = None,
                           want_flags: bool = False,
                           want_ne: bool = False) -> Selection:
    """The nearest sweep's finality test on its pass 1 (t, idx; on the
    card K5's merged ``words``) and the compaction of its unfinished lanes
    into ``m`` slots: csrc/two_pass.cu's nearest entry on a CUDA tensor,
    ``two_pass_flags_plain`` and ``select_compact_plain`` on a CPU one.
    ``box``: the scene's box (``scene_cluster_box``); ``ncand``: the full
    lists' counts, which ``ncand_fb`` copies where taken."""
    if o3.device.type == "cpu":
        flags, ne = two_pass_flags_plain(o3, d3_unit, aabb8, drops, r_blk,
                                         torch.where(idx >= 0, t, BIG),
                                         box=box)
        return _plain_selection(flags, ne, m, o3, d3_unit, None, ncand,
                                want_flags, want_ne)
    if words is None:
        raise ValueError("the nearest select on the card reads pass 1's "
                         "words")
    return _launch_select("ptt_two_pass_nearest_select",
                          _NEAREST_SELECT_ARGTYPES, [words], o3, d3_unit,
                          None, m, ncand,
                          _drop_args(aabb8, box, drops, r_blk, o3.device),
                          _tiles(o3.shape[1], r_blk), want_flags, want_ne)


def any_hit_select_compact(o3, d3_unit, maxd, occ, aabb8, box,
                           drops: Drops, r_blk: int, m: int,
                           ncand: torch.Tensor | None = None,
                           want_flags: bool = False,
                           want_ne: bool = False) -> Selection:
    """The any-hit's finality test on its pass 1 ``occ`` and the compaction
    of its open lanes (with their windows) into ``m`` slots: csrc/
    two_pass.cu's any-hit entry on a CUDA tensor, the plain twins on a CPU
    one; the arguments as ``nearest_select_compact``'s."""
    if o3.device.type == "cpu":
        flags, ne = two_pass_flags_plain(o3, d3_unit, aabb8, drops, r_blk,
                                         maxd, any_hit_open(occ, maxd),
                                         box=box)
        return _plain_selection(flags, ne, m, o3, d3_unit, maxd, ncand,
                                want_flags, want_ne)
    check_input("occ", occ, o3.device, torch.bool, (o3.shape[1],))
    return _launch_select("ptt_two_pass_any_hit_select",
                          _ANY_HIT_SELECT_ARGTYPES, [occ, maxd], o3, d3_unit,
                          maxd, m, ncand,
                          _drop_args(aabb8, box, drops, r_blk, o3.device),
                          _tiles(o3.shape[1], r_blk), want_flags, want_ne)


def select_compact(unfinished: torch.Tensor, m: int, o3, d3_unit,
                   maxd: torch.Tensor | None = None,
                   ncand: torch.Tensor | None = None) -> Selection:
    """The compaction of the lanes ``unfinished`` bool[N] into ``m`` slots
    (with their windows where ``maxd`` is given): csrc/two_pass.cu's
    compact entry on a CUDA tensor, ``select_compact_plain`` on a CPU
    one."""
    if o3.device.type == "cpu":
        return select_compact_plain(unfinished, m, o3, d3_unit, maxd, ncand)
    check_input("unfinished", unfinished, o3.device, torch.bool,
                (o3.shape[1],))
    return _launch_select("ptt_select_compact", _COMPACT_ARGTYPES,
                          [unfinished, maxd], o3, d3_unit, maxd, m, ncand,
                          None, _tiles(o3.shape[1], SELECT_TILE))


def _plain_selection(flags, ne, m, o3, d3_unit, maxd, ncand, want_flags,
                     want_ne) -> Selection:
    s = select_compact_plain(flags, m, o3, d3_unit, maxd, ncand)
    return s._replace(flags=flags if want_flags else None,
                      ne=ne if want_ne else None)


def _tiles(n: int, r_blk: int) -> int:
    """The select kernel's CTAs: each covers one slice of SELECT_TILE
    lanes of one ray block of ``r_blk``."""
    return -(-n // r_blk) * -(-r_blk // SELECT_TILE)


def _drop_args(aabb8, box, drops: Drops, r_blk: int, device) -> list:
    """The finality entries' drop arguments, checked: the kernel reads
    aabb8's rows as 16-byte vectors."""
    check_input("aabb8", aabb8, device, torch.float32, (None, 8))
    check_input("scene box", box, device, torch.float32, (8,))
    if aabb8.data_ptr() % 16:
        raise ValueError("aabb8 must be 16-byte aligned")
    nrb, lane_m = drops.ids.shape
    check_input("drop ids", drops.ids, device, torch.int32, (nrb, lane_m))
    check_input("drop keys", drops.keys, device, torch.float32,
                (nrb, lane_m))
    check_input("far", drops.far, device, torch.float32, (nrb,))
    return [aabb8.data_ptr(), box.data_ptr(), drops.ids.data_ptr(),
            drops.keys.data_ptr(), drops.far.data_ptr(), lane_m, r_blk]


def _launch_select(entry: str, argtypes: list, state: list, o3, d3_unit,
                   maxd, m: int, ncand, drop_args: list | None, tiles: int,
                   want_flags: bool = False,
                   want_ne: bool = False) -> Selection:
    """Launch ``entry``, one of csrc/two_pass.cu's three entries, on
    ``state`` (pass 1's: [words] of K5, [occ, maxd] of K6; the compact
    entry's [flags, maxd]) with ``drop_args`` (None for the compact
    entry), into ``m`` slots; the scratch of its ``tiles`` status words
    and tile counter zeroed here."""
    global SELECT_LAUNCHES
    n, device = o3.shape[1], o3.device
    if m < 1:
        raise ValueError(f"pass 2 needs at least one slot, not {m}")
    if ncand is not None:
        check_input("ncand", ncand, device, torch.int32, (None,))
    empty = lambda *shape, dtype=torch.float32: torch.empty(
        shape, dtype=dtype, device=device)
    scratch = torch.zeros(tiles + 1, dtype=torch.int64, device=device)
    sel, count = empty(m, dtype=torch.int64), empty(1, dtype=torch.int32)
    taken = empty(1, dtype=torch.bool)
    rays = (empty(3, m), empty(3, m)) + (() if maxd is None else (empty(m),))
    ncand_fb = None if ncand is None else torch.empty_like(ncand)
    flags = empty(n, dtype=torch.bool) if want_flags else None
    ne = empty(n) if want_ne else None
    ptr = lambda x: None if x is None else x.data_ptr()
    slots = [m, ptr(ncand), 0 if ncand is None else ncand.shape[0],
             scratch.data_ptr(), sel.data_ptr(), count.data_ptr(),
             taken.data_ptr(), rays[0].data_ptr(), rays[1].data_ptr(),
             ptr(rays[2] if len(rays) == 3 else None), ptr(ncand_fb)]
    fn = build.function(entry, argtypes)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(o3.data_ptr(), d3_unit.data_ptr(), n,
             *(ptr(x) for x in state), *(drop_args or []), *slots,
             *([] if drop_args is None else [ptr(flags), ptr(ne)]),
             device.index, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: kernel launch failed: CUDA error {err}")
    SELECT_LAUNCHES += 1
    return Selection(sel, count, taken, rays, ncand_fb, flags, ne)


def two_pass_nearest(sweep, o3, d3_unit, aabb8, box, lists: BlockLists,
                     r_blk: int, k: int, m_div: int = M_DIV):
    """The two-pass nearest sweep over the full ``lists`` of (o3,
    d3_unit): ``sweep(o3, d3_unit, lists, words)`` is the one-pass sweep
    (K5 or K3's sparse nearest, which fill ``words``, the scratch of
    ``walk_words``, on the card; a plain walk on the CPU). Pass 1 over the
    first ``k`` slots, ``nearest_select_compact`` into ``pass2_size(N,
    r_blk, m_div)`` slots, pass 2 over the slots' own lists, and the
    one-pass sweep of the whole wavefront over the lists with the counts
    ``ncand_fb`` (nothing to walk unless the survivors did not fit);
    ``taken`` picks. ``box``: the scene's box (``scene_cluster_box``).
    Returns (t, idx), the one-pass result."""
    n = o3.shape[1]
    head, drops = truncate_lists(lists, k)
    words = None if o3.device.type == "cpu" else walk_words(n, o3.device)
    t1, i1 = sweep(o3, d3_unit, head, words)
    m = pass2_size(n, r_blk, m_div)
    s = nearest_select_compact(o3, d3_unit, aabb8, box, drops, r_blk, t1, i1,
                               words, m, lists.ncand)
    o2, d2 = s.rays
    tmax = torch.full((m // r_blk,), BIG, dtype=o3.dtype, device=o3.device)
    t2, i2 = sweep(o2, d2, block_lists(aabb8, o2, d2, tmax, r_blk))
    t_all, i_all = sweep(o3, d3_unit, lists._replace(ncand=s.ncand_fb))
    return (torch.where(s.taken, t_all, scatter_back(t1, s.sel, t2)),
            torch.where(s.taken, i_all, scatter_back(i1, s.sel, i2)))


def two_pass_any_hit(sweep, o3, d3_unit, maxd, aabb8, box,
                     lists: BlockLists, k: int,
                     m_div: int = M_DIV) -> torch.Tensor:
    """The two-pass any-hit over the full window ``lists`` (blocks of
    R_BLK): ``sweep(o3, d3_unit, maxd, lists)`` is the one-pass sweep (K6
    or K3's sparse any-hit; a plain walk on the CPU). Pass 1 over the first
    ``k`` slots, ``any_hit_select_compact``, pass 2 over the compacted open
    lanes (occlusions of pass 1 are real hits, so final), and the whole
    wavefront over the lists with the counts ``ncand_fb``, as in
    ``two_pass_nearest``. Returns the one-pass bits."""
    n = o3.shape[1]
    head, drops = truncate_lists(lists, k)
    occ1 = sweep(o3, d3_unit, maxd, head)
    m = pass2_size(n, R_BLK, m_div)
    s = any_hit_select_compact(o3, d3_unit, maxd, occ1, aabb8, box, drops,
                               R_BLK, m, lists.ncand)
    occ2 = sweep(*s.rays, window_lists(aabb8, *s.rays, R_BLK))
    occ_all = sweep(o3, d3_unit, maxd, lists._replace(ncand=s.ncand_fb))
    return torch.where(s.taken, occ_all, scatter_back(occ1, s.sel, occ2))


def sparse_any_hit_cached_cm(o3: torch.Tensor, d3_unit: torch.Tensor,
                             maxd: torch.Tensor, scene,
                             guess_cl: torch.Tensor,
                             relevant: torch.Tensor | None = None):
    """K7 with the occluder cache's two passes. ``guess_cl`` i32[N] is each
    lane's cached blocking cluster (-1: none; any other content is safe).
    Returns (occ bool[N], blocked_cl i32[N]: the cluster that proved each
    occluded lane, -1 for the others).

    ``occ`` is ``sparse_any_hit_cm``'s for any cache contents (on the card
    K7 walks K6's culled walk, so the two agree by construction). Pass 1
    sweeps each block's ``guess_lists``: its occlusions are real triangle
    hits, so they are final. The lanes it left open re-sweep their full
    candidate lists in pass 2: compacted to ``pass2_size(N)`` lanes (the
    tail parked) when they fit, else the whole wavefront (a cold cache);
    ``cached_passes`` runs the two. ``relevant`` bool[N] (optional): lanes
    whose result the caller discards (False) do not vote and never reach
    pass 2, so exactness holds on relevant lanes only."""
    o3, d3_unit, maxd, scene = detach_occlusion(o3, d3_unit, maxd, scene)
    device = o3.device
    n, tripack, aabb8 = check_rays(o3, d3_unit, scene, "cached any-hit",
                                    maxd)
    check_input("guess_cl", guess_cl, device, torch.int32, (n,))
    if relevant is not None:
        check_input("relevant", relevant, device, torch.bool, (n,))
    if n == 0:
        return (torch.zeros(0, dtype=torch.bool, device=device),
                torch.zeros(0, dtype=torch.int32, device=device))
    cull = None if device.type == "cpu" else scene_cluster_cull_boxes(scene)
    first, second, sel = cached_passes(o3, d3_unit, maxd, tripack, aabb8,
                                       cull, guess_cl, relevant)
    if sel is None:
        return second.occ, second.cl
    return (scatter_back(first.occ, sel, second.occ),
            scatter_back(first.cl, sel, second.cl))


class CachedPass(NamedTuple):
    """One of K7's two passes as ``cached_passes`` ran it: its rays (o3,
    d3_unit, maxd), its lists and its outputs (occ, blocked_cl)."""

    rays: tuple
    lists: BlockLists
    occ: torch.Tensor
    cl: torch.Tensor


def cached_passes(o3, d3_unit, maxd, tripack, aabb8, cull, guess_cl,
                  relevant=None):
    """The occluder cache's two passes, as ``sparse_any_hit_cached_cm``
    runs them on its checked inputs: K7 with the cluster boxes ``cull``,
    or its plain version where ``cull`` is None (a CPU wavefront). Returns
    (pass 1, pass 2, sel), each pass a ``CachedPass``: pass 1 over the
    ``guess_lists`` of ``guess_cl`` (-1 on the lanes ``relevant`` leaves
    out), pass 2 over the full lists of the lanes that pass 1 left open,
    compacted by ``select_compact`` (csrc/two_pass.cu's compact entry on
    the card) to ``pass2_size(N)`` slots with the tail parked at
    PARK_ORIGIN with window 1: ``sel`` i64 holds each slot's lane (N for a
    parked slot); it is None where the open lanes do not fit and pass 2 ran
    on the whole wavefront.

    Choosing between the two reads the kernel's ``taken`` word on the
    host: one synchronization per call, which the JAX package's
    ``lax.cond`` does not pay. Choosing on the device, as the uncached
    two-pass sweeps do, would build the whole wavefront's window lists on
    every call, so the read stays until the bounce sweep is captured in a
    CUDA graph, which decides it."""
    if cull is None:
        def run(rays, lists):
            occ, cl = sparse_any_hit_idx_plain(*rays, tripack, aabb8, lists,
                                               R_BLK)
            return CachedPass(rays, lists, occ, cl)
    else:
        def run(rays, lists):
            occ, cl = _launch_any_hit_idx(*rays, tripack, aabb8, lists,
                                          R_BLK, cull)
            return CachedPass(rays, lists, occ, cl)

    if relevant is not None:
        guess_cl = torch.where(relevant, guess_cl, -1)  # parked: no vote
    rays = (o3, d3_unit, maxd)
    first = run(rays, guess_lists(guess_cl, aabb8.shape[0], R_BLK))
    unfinished = ~first.occ if relevant is None else ~first.occ & relevant
    s = select_compact(unfinished, pass2_size(o3.shape[1]), *rays)
    with span("ptt.host_read"):
        taken = bool(s.taken)
    if taken:
        return first, run(rays, window_lists(aabb8, *rays, R_BLK)), None
    return first, run(s.rays, window_lists(aabb8, *s.rays, R_BLK)), s.sel


def walk_words(n: int, device) -> torch.Tensor:
    """The split nearest walks' scratch: one 64-bit word per lane with
    every bit set, "no hit yet" (``csrc/cluster.cuh``). Filling it is one
    device operation."""
    return torch.full((n,), -1, dtype=torch.int64, device=device)


def walk_units(lists: BlockLists, r_blk: int,
               segment: int = WALK_SEGMENT) -> int:
    """The units a split walk launches over ``lists``: per block, its CTAs
    (slices of 256 lanes, ``kThreads`` of csrc/mt.cuh) times its segments of
    ``segment`` slots (WALK_SEGMENT for the nearest walks, ANY_HIT_SEGMENT
    for the any-hit walks)."""
    slices = -(-r_blk // 256)
    return slices * int((-(-lists.ncand // segment)).sum())


def walk_stats(stats: torch.Tensor) -> dict:
    """What the counting instance of a split nearest walk (K5, K3's sparse
    nearest, K8) added to ``stats`` i64[3] in one launch: units launched
    (CTAs with list slots to walk), the units that stopped before their
    first slot, and the (ray, cluster) visits through the per-lane gate."""
    launched, stopped, visits = stats.tolist()
    return {"units_launched": launched, "units_stopped_at_once": stopped,
            "visits": visits}


def _launch_nearest(o3, d3_unit, pack, aabb8, lists, r_blk, entry: str,
                    stats: torch.Tensor | None = None,
                    words: torch.Tensor | None = None):
    n = o3.shape[1]
    if words is None:
        words = walk_words(n, o3.device)
    t = torch.empty(n, dtype=torch.float32, device=o3.device)
    idx = torch.empty(n, dtype=torch.int32, device=o3.device)
    fn = build.function(entry, _ARGTYPES)
    stream = torch.cuda.current_stream(o3.device).cuda_stream
    err = fn(o3.data_ptr(), d3_unit.data_ptr(), n, pack.data_ptr(),
             aabb8.data_ptr(), lists.ids.shape[1], lists.ids.data_ptr(),
             lists.keys.data_ptr(), lists.ncand.data_ptr(), r_blk,
             words.data_ptr(), t.data_ptr(), idx.data_ptr(),
             None if stats is None else stats.data_ptr(), o3.device.index,
             stream)
    if err != 0:
        raise RuntimeError(f"{entry}: kernel launch failed: CUDA error {err}")
    return t, idx


def _launch(o3, d3_unit, tripack, aabb8, lists, r_blk, stats=None,
            words=None):
    """K5 over ``lists``: (t, idx). ``words``: the scratch of
    ``walk_words``, for a caller that reads the merged words after it (the
    two-pass protocol's finality test); None makes one."""
    global LAUNCHES
    out = _launch_nearest(o3, d3_unit, tripack, aabb8, lists, r_blk,
                          "ptt_sparse_nearest", stats, words)
    LAUNCHES += 1
    return out


def _launch_plucker(o3, d3_unit, pack36, aabb8, lists, r_blk, stats=None,
                    words=None):
    global PLUCKER_LAUNCHES
    out = _launch_nearest(o3, d3_unit, pack36, aabb8, lists, r_blk,
                          "ptt_plucker_sparse_nearest", stats, words)
    PLUCKER_LAUNCHES += 1
    return out


def launch_occlusion(o3, d3_unit, maxd, pack, aabb8, lists, r_blk,
                     entry: str, cull: torch.Tensor,
                     stats: torch.Tensor | None = None):
    """Launch ``entry``, one of the split any-hit walks that share
    ``_ANY_HIT_ARGTYPES`` (K6, K3's sparse any-hit, K9), over ``lists``;
    returns its occlusion marks, bool[N]. The callers count the launch."""
    n = o3.shape[1]
    # zeroed: the kernel's units only ever set a lane's mark
    occ = torch.zeros(n, dtype=torch.bool, device=o3.device)
    fn = build.function(entry, _ANY_HIT_ARGTYPES)
    stream = torch.cuda.current_stream(o3.device).cuda_stream
    err = fn(o3.data_ptr(), d3_unit.data_ptr(), maxd.data_ptr(), n,
             pack.data_ptr(), aabb8.data_ptr(), cull.data_ptr(),
             lists.ids.data_ptr(), lists.keys.data_ptr(),
             lists.ncand.data_ptr(), lists.ids.shape[1], r_blk,
             occ.data_ptr(), None if stats is None else stats.data_ptr(),
             o3.device.index, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: kernel launch failed: CUDA error {err}")
    return occ


def _launch_any_hit(o3, d3_unit, maxd, tripack, aabb8, lists, r_blk, cull,
                    stats=None):
    global ANY_HIT_LAUNCHES
    occ = launch_occlusion(o3, d3_unit, maxd, tripack, aabb8, lists, r_blk,
                           "ptt_sparse_any_hit", cull, stats)
    ANY_HIT_LAUNCHES += 1
    return occ


def _launch_plucker_any_hit(o3, d3_unit, maxd, pack36, aabb8, lists, r_blk,
                            cull, stats=None):
    global PLUCKER_ANY_HIT_LAUNCHES
    occ = launch_occlusion(o3, d3_unit, maxd, pack36, aabb8, lists, r_blk,
                           "ptt_plucker_sparse_any_hit", cull, stats)
    PLUCKER_ANY_HIT_LAUNCHES += 1
    return occ


def _launch_any_hit_idx(o3, d3_unit, maxd, tripack, aabb8, lists, r_blk,
                        cull, stats=None):
    """K7 over ``lists``: (occlusion bool[N], first blocking cluster i32[N]).
    ``cull``: ``cluster_cull_boxes``; ``stats``: None, or the seven
    counters of ``ANY_HIT_COUNTS`` that the walk adds to."""
    global ANY_HIT_IDX_LAUNCHES
    n = o3.shape[1]
    device = o3.device
    # scratch: each lane's first blocking list slot, taken by atomicMin
    first_slot = torch.full((n,), IMAX, dtype=torch.int32, device=device)
    occ = torch.empty(n, dtype=torch.bool, device=device)
    blocked = torch.empty(n, dtype=torch.int32, device=device)
    fn = build.function("ptt_sparse_any_hit_idx", _ANY_HIT_IDX_ARGTYPES)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(o3.data_ptr(), d3_unit.data_ptr(), maxd.data_ptr(), n,
             tripack.data_ptr(), aabb8.data_ptr(), cull.data_ptr(),
             lists.ids.data_ptr(), lists.keys.data_ptr(),
             lists.ncand.data_ptr(), lists.ids.shape[1], r_blk,
             first_slot.data_ptr(), occ.data_ptr(), blocked.data_ptr(),
             None if stats is None else stats.data_ptr(), device.index,
             stream)
    if err != 0:
        raise RuntimeError(
            f"cached any-hit kernel launch failed: CUDA error {err}")
    ANY_HIT_IDX_LAUNCHES += 1
    return occ, blocked
