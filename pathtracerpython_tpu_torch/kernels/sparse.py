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
  Choosing pass 2's form reads the open lanes' count on the host once a
  call, where the JAX package branches on the device (``lax.cond``).

**K3, the Plücker form.** K5 and K6 follow the ``MT_IMPL`` knob of
``kernels/intersect.py`` (or their ``mt_impl`` keyword), as
``_sparse_plucker`` makes the JAX package's sparse sweeps follow it: under
"plucker" the same walks test a ray against the 36-column Plücker rows
(``scene_plucker_pack``; clusters, AABBs and lists stay the classic
pack's) and give the dense Plücker sweep's result bit for bit. K7 has no
Plücker form and stays classic under the knob, as in the JAX package.

Left behind as TPU machinery: the packed [seg|active|rb|cl] work words,
the SMEM budgets (``W_PER_RB``, ``CHUNK_RB``, ``W_SMEM_ENTRIES``), grouping,
the grid cascade, the interpret-mode caps, and the truncated-list two-pass
protocol of the uncached sweeps (``two_pass`` / ``PASS1_K``) with
``REFINE_K``, both off by default there. The occluder cache's own two
passes are ported (K7).

On a CUDA tensor each wrapper launches its kernel (``csrc/sparse_nearest.cu``,
``csrc/sparse_any_hit.cu``, ``csrc/sparse_any_hit_idx.cu``; the first two
hold both forms) or raises; on a
CPU tensor it runs its plain version, the same walk in PyTorch, vectorized
over ray blocks slot by slot. Forward only.
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
    resolve_mt_impl,
    scene_cull_boxes,
    scene_plucker_pack,
    scene_tripack,
)
from pathtracerpython_tpu_torch.ops.sort import PARK_DIR, PARK_ORIGIN

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

# Launches of the CUDA kernels since the counts were last reset: K5, K6, K7,
# and K3's cluster-sparse nearest and any-hit.
LAUNCHES = 0
ANY_HIT_LAUNCHES = 0
ANY_HIT_IDX_LAUNCHES = 0
PLUCKER_LAUNCHES = 0
PLUCKER_ANY_HIT_LAUNCHES = 0

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
                            r_blk: int = R_BLK, mt_impl: str | None = None):
    """Closest forward hit of rays o3/d3_unit f32[3, N] (d3_unit of unit
    length) through the cluster hierarchy, in blocks of ``r_blk`` rays
    (the sparse hierarchy's R_BLK; the hybrid passes
    R_BLK_HYBRID_NEAREST); the result of the dense ``nearest_t_idx_cm`` in
    the same form ``mt_impl`` (None: ``intersect.MT_IMPL``), bit for bit:
    (t [N] — 0 on a miss, idx [N] int32 — -1 on a miss)."""
    plucker = resolve_mt_impl(mt_impl) == "plucker"
    device = o3.device
    n, tripack, aabb8 = check_rays(o3, d3_unit, scene, "sparse nearest-hit")
    if n == 0:
        return (torch.zeros(0, dtype=o3.dtype, device=device),
                torch.zeros(0, dtype=torch.int32, device=device))
    nrb = -(-n // r_blk)
    tmax = torch.full((nrb,), BIG, dtype=o3.dtype, device=device)
    lists = block_lists(aabb8, o3, d3_unit, tmax, r_blk)
    if plucker:
        # the clusters and their boxes are the classic pack's; only the
        # rows a ray is tested against change
        pack36 = scene_plucker_pack(scene, PACK_ROWS)
        sweep = (sparse_nearest_plucker_plain if device.type == "cpu"
                 else _launch_plucker)
        return sweep(o3, d3_unit, pack36, aabb8, lists, r_blk)
    if device.type == "cpu":
        return sparse_nearest_plain(o3, d3_unit, tripack, aabb8, lists, r_blk)
    return _launch(o3, d3_unit, tripack, aabb8, lists, r_blk)


def sparse_any_hit_cm(o3: torch.Tensor, d3_unit: torch.Tensor,
                      maxd: torch.Tensor, scene,
                      mt_impl: str | None = None) -> torch.Tensor:
    """K6: whether an occluder triangle blocks each shadow ray o3/d3_unit
    f32[3, N] (d3_unit of unit length) at t < maxd - 1e-4, through the
    cluster hierarchy in blocks of R_BLK rays; bool[N], the result of the
    dense ``any_hit_cm`` in the same form ``mt_impl`` (None:
    ``intersect.MT_IMPL``). Lanes with maxd = 0 (parked) are never
    occluded. The cached any-hit K7 (``sparse_any_hit_cached_cm``) has no
    Plücker form and stays classic under the knob, as in the JAX
    package."""
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
        return plain(o3, d3_unit, maxd, pack, aabb8, lists, R_BLK)
    # the clusters, their boxes and the lists are the classic pack's; only
    # the rows a ray is tested against change with the form
    launch = _launch_plucker_any_hit if plucker else _launch_any_hit
    return launch(o3, d3_unit, maxd, pack, aabb8, lists, R_BLK,
                  scene_cluster_cull_boxes(scene))


def pass2_size(n: int, r_blk: int = R_BLK, m_div: int = CACHE_M_DIV) -> int:
    """Lanes of K7's compacted pass 2 for a wavefront of ``n``: n / m_div,
    at least one block, in whole blocks (``_pass2_size`` on the wavefront
    padded to whole blocks)."""
    n_pad = -(-n // r_blk) * r_blk
    m = max(r_blk, -(-n_pad // m_div))
    return -(-m // r_blk) * r_blk


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
    ``cached_passes`` runs the two. ``relevant`` bool[N] (optional): lanes whose result the caller
    discards (False) do not vote and never reach pass 2, so exactness
    holds on relevant lanes only.

    Choosing the branch reads the open lanes' count on the host: one
    synchronization per call, which the JAX package's ``lax.cond`` does
    not pay. It stays until the bounce sweep is captured in a CUDA graph,
    which needs that choice made on the device."""
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
    cnt = sel.shape[0]
    return (first.occ.index_copy(0, sel, second.occ[:cnt]),
            first.cl.index_copy(0, sel, second.cl[:cnt]))


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
    out), pass 2 over the full lists of the ``sel`` lanes (i64, in lane
    order) that pass 1 left open, compacted to ``pass2_size(N)`` lanes with
    the tail parked at PARK_ORIGIN with window 1; ``sel`` is None where the
    open lanes do not fit and pass 2 ran on the whole wavefront."""
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
    sel = torch.nonzero(unfinished).flatten()  # stable; the host read
    cnt, m = sel.shape[0], pass2_size(o3.shape[1])
    if cnt > m:
        return first, run(rays, window_lists(aabb8, *rays, R_BLK)), None
    o2 = o3.new_tensor(PARK_ORIGIN)[:, None].repeat(1, m)
    d2 = o3.new_tensor(PARK_DIR)[:, None].repeat(1, m)
    md2 = torch.ones(m, dtype=maxd.dtype, device=maxd.device)
    o2[:, :cnt] = o3[:, sel]
    d2[:, :cnt] = d3_unit[:, sel]
    md2[:cnt] = maxd[sel]
    rays2 = (o2, d2, md2)
    return first, run(rays2, window_lists(aabb8, *rays2, R_BLK)), sel


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
                    stats: torch.Tensor | None = None):
    n = o3.shape[1]
    words = walk_words(n, o3.device)
    t = torch.empty(n, dtype=torch.float32, device=o3.device)
    idx = torch.empty(n, dtype=torch.int32, device=o3.device)
    fn = build.function(entry, _ARGTYPES)
    stream = torch.cuda.current_stream(o3.device).cuda_stream
    err = fn(o3.data_ptr(), d3_unit.data_ptr(), n, pack.data_ptr(),
             aabb8.data_ptr(), aabb8.shape[0], lists.ids.data_ptr(),
             lists.keys.data_ptr(), lists.ncand.data_ptr(), r_blk,
             words.data_ptr(), t.data_ptr(), idx.data_ptr(),
             None if stats is None else stats.data_ptr(), o3.device.index,
             stream)
    if err != 0:
        raise RuntimeError(f"{entry}: kernel launch failed: CUDA error {err}")
    return t, idx


def _launch(o3, d3_unit, tripack, aabb8, lists, r_blk, stats=None):
    global LAUNCHES
    out = _launch_nearest(o3, d3_unit, tripack, aabb8, lists, r_blk,
                          "ptt_sparse_nearest", stats)
    LAUNCHES += 1
    return out


def _launch_plucker(o3, d3_unit, pack36, aabb8, lists, r_blk, stats=None):
    global PLUCKER_LAUNCHES
    out = _launch_nearest(o3, d3_unit, pack36, aabb8, lists, r_blk,
                          "ptt_plucker_sparse_nearest", stats)
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
