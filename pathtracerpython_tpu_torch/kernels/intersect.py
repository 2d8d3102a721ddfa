"""K1, K4 and the dense half of K3: the dense nearest-hit and any-hit
sweeps in the classic and the Plücker form — CUDA kernel wrappers and plain
versions.

``nearest_t_idx_cm`` (K1) has the signature of the JAX package's
``kernels/intersect_pallas.py:nearest_t_idx_cm``, ``any_hit_cm`` (K4) that of
its ``any_hit_pallas_cm``. On a CUDA tensor each launches its kernel
(``csrc/nearest.cu``, ``csrc/any_hit.cu``) or raises; on a CPU tensor it runs
its plain version, the same arithmetic in PyTorch: Möller–Trumbore in
``_mt_rows``' component order, then the per-ray (t, index) minimum with the
smallest index winning ties (K1), or any occluder hit with
t < maxd - 1e-4 (K4).

**Gradients** follow the JAX package's custom VJPs, which lie outside its
Pallas kernels. Where the rays or the scene's vertices require grad, the
nearest sweep runs under ``NearestTIdx``: the kernel (or its plain
version) finds (t, idx) on detached inputs, and the backward re-solves t
on each lane's winning row of the differentiable ``scene_tripack`` with
``ops/geometry.py:intersect_moller`` and scatters dt/d(origin, direction,
vertices), a miss getting zero (``_nearest_bwd``). The index is discrete
and carries none. ``nearest_entry`` does this for K1, K5, K8 and K3's
nearest sweeps alike, so their gradients are one function of (t, idx).
The any-hit sweeps detach their inputs (``detach_occlusion``): occlusion
is detached by design, as the JAX package's ``stop_gradient`` has it.
Where nothing requires grad the entries call the sweeps directly.

**The in-triangle test has two forms** (K3), chosen by ``MT_IMPL``, the
JAX package's knob of the same name, or by the ``mt_impl`` keyword of a
sweep, which overrides it: ``"classic"`` is Möller–Trumbore; ``"plucker"``
decides inside/outside by the signs of three edge side products (edge
direction | edge moment) · (o x d | d) and takes t from the triangle's
plane, t = n·(v0 - o) / (n·d) with n = e1 x e2 unnormalized
(``plucker_rows``, after ``_plucker_block``). The merges are unchanged. The
two forms round differently, so winners and occlusion bits may differ on
rays that graze a triangle's edge, and nowhere else. The knob is read at
every call. The dense sweeps here and the cluster-sparse sweeps K5 and K6
(``kernels/sparse.py``) follow it; the fused NEE (K2), the cached any-hit
(K7) and the walker sweeps (K8, K9) stay classic, as in the JAX package.

**Every dense kernel culls by boxes**: a lane tests a block of rows only
when its segment, up to its limit, meets the block's AABB under the slab
test of ``_aabb_cull_rows`` (``aabb_cull_rows``). The any-hit kernels cull
over the occluder rows up to the segment's end (``cull_boxes``,
``scene_cull_boxes``), the nearest kernels over every valid row, the
light's too, up to the lane's running best t (``nearest_cull_boxes``,
``scene_nearest_cull_boxes``; the bound of ``_nearest_kernel_cull``). The
kernels do so at two sizes, the tile of ``TILE_ROWS`` rows and a group of
``CULL_GROUP`` rows (``csrc/aabb.cuh``), on a scene of one tile too:
measured on the card, the group level pays there as well, where the TPU
kernels' ``_use_cull`` keeps one block un-culled. The boxes are grown a
little at build time and the limit is stretched by ``CULL_REACH``, so that
no pair is skipped that a conditioned pair test (|det| >= 1e-3 |e1||e2|)
accepts: the result does not change by one bit. Below that conditioning
(a ray within 1e-3 rad of a triangle's plane, or a triangle that thin) the
pair test's own u, v and t are rounding noise, and a culled sweep may drop
a hit that the un-culled one reports, here as in the JAX package.
``any_hit_plain`` and ``nearest_t_idx_plain`` without ``cull`` are the
oracles; with ``cull`` they test the pairs the kernel tests.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from pathtracerpython_tpu_torch.kernels import build
from pathtracerpython_tpu_torch.ops.gather import scatter_rows

OCCLUDER_COL = 10  # of the [T, 12] pack; 9 is valid
DET_EPS = 1e-7  # |det| > DET_EPS: not parallel
T_MIN = 1e-4    # forward near-clip, t > T_MIN
BIG = 3.0e38    # "no hit yet"
IMAX = 2**31 - 1

# The plain sweeps hold [rows, N] temporaries; rows per chunk are chosen so
# one temporary stays under this many elements.
PLAIN_CHUNK_ELEMS = 1 << 24

# The in-triangle test of the sweeps that follow the knob: "classic" or
# "plucker". Read at every call; a sweep's ``mt_impl`` keyword overrides it.
MT_IMPL = "classic"
MT_IMPLS = ("classic", "plucker")

# Launches of the CUDA kernels since the counts were last reset: K1, K4,
# and K3's dense nearest and any-hit.
LAUNCHES = 0
ANY_HIT_LAUNCHES = 0
PLUCKER_LAUNCHES = 0
PLUCKER_ANY_HIT_LAUNCHES = 0

PLUCKER_COLS = 36  # e0 (8) | e1 (8) | e2 (8) | n v0 valid occluder 0x4 (12)

TILE_ROWS = 256          # rows a block stages at a time (csrc/mt.cuh kTile)
CULL_GROUP = 2           # rows a group box (csrc/aabb.cuh kGroup; PERF.md)
CULL_SLACK = 1e-3        # absolute slack in t of the slab test
# A culled sweep's slab tests run up to the lane's limit times CULL_REACH:
# the pair tests' t carries an error that grows with t, which the absolute
# slack alone does not cover for far origins.
CULL_REACH = 1.001
# A box is grown by CULL_PAD * max(1, |min|, |max|) per component: the pair
# tests accept rays that pass a triangle's edge by their own rounding error
# (about 1e-6 of the coordinates), the boxes must not reject them.
CULL_PAD = 1e-4

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # o3, d3, n
    ctypes.c_void_p, ctypes.c_int,                    # tripack, t_count
    ctypes.c_void_p, ctypes.c_void_p,                 # tile, group boxes
    ctypes.c_void_p, ctypes.c_void_p,                 # t_out, idx_out
    ctypes.c_void_p,                                  # stats
    ctypes.c_int, ctypes.c_void_p,                    # device, stream
]
_ANY_HIT_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # o3, d3, maxd
    ctypes.c_int,                                       # n
    ctypes.c_void_p, ctypes.c_int,                      # tripack, t_count
    ctypes.c_void_p, ctypes.c_void_p,                   # tile, group boxes
    ctypes.c_void_p, ctypes.c_void_p,                   # occ_out, stats
    ctypes.c_int, ctypes.c_void_p,                      # device, stream
]


def scene_tripack(scene) -> torch.Tensor:
    """f32[T, 12] triangle pack: v0.xyz | v1.xyz | v2.xyz | valid |
    occluder | 0, the layout both kernels read."""
    v0 = scene.tri_v0
    flag = lambda m: m.to(v0.dtype)[:, None]
    return torch.cat(
        [v0, scene.tri_v1, scene.tri_v2, flag(scene.tri_valid),
         flag(scene.tri_occluder), torch.zeros_like(v0[:, :1])],
        dim=1,
    ).contiguous()


def mt_rows(tri: torch.Tensor, ox, oy, oz, dx, dy, dz):
    """Möller–Trumbore of [..., T, 12] pack rows against [..., 1, R] ray
    rows -> (hit [..., T, R] incl. the valid column, t [..., T, R]); the
    operation order of ``intersect_pallas.py:_mt_rows``."""
    col = lambda c: tri[..., c:c + 1]
    v0x, v0y, v0z = col(0), col(1), col(2)
    e1x, e1y, e1z = col(3) - v0x, col(4) - v0y, col(5) - v0z
    e2x, e2y, e2z = col(6) - v0x, col(7) - v0y, col(8) - v0z

    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    not_par = torch.abs(det) > DET_EPS
    inv_det = 1.0 / torch.where(not_par, det, 1.0)

    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det

    hit = (
        not_par & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN)
        & (col(9) > 0.5)
    )
    return hit, t


def resolve_mt_impl(mt_impl: str | None) -> str:
    """The form a sweep runs: its ``mt_impl`` keyword, or the module's
    ``MT_IMPL`` when that is None."""
    impl = MT_IMPL if mt_impl is None else mt_impl
    if impl not in MT_IMPLS:
        raise ValueError(f"mt_impl={impl!r}: expected one of {MT_IMPLS}")
    return impl


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b along the last axis of [..., 3], each component one product
    minus another, in ``jnp.cross``'s order."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def plucker_pack(tripack: torch.Tensor) -> torch.Tensor:
    """The Plücker operands of a [T, 12] pack as one f32[T, 36] pack, the
    layout the Plücker kernels read: per edge (v0v1, v1v2, v2v0) eight
    columns direction | moment a x b | 0 0, then n = e1 x e2 unnormalized |
    v0 | valid | occluder | 0 0 0 0. A zero (pad) row gives a zero row."""
    v0, v1, v2 = tripack[:, 0:3], tripack[:, 3:6], tripack[:, 6:9]
    zeros = tripack.new_zeros((tripack.shape[0], 4))
    edges = [
        torch.cat([b - a, _cross(a, b), zeros[:, :2]], dim=1)
        for a, b in ((v0, v1), (v1, v2), (v2, v0))
    ]
    n = _cross(v1 - v0, v2 - v0)
    return torch.cat([*edges, n, v0, tripack[:, 9:11], zeros],
                     dim=1).contiguous()


def plucker_packs(tripack: torch.Tensor):
    """``_plucker_packs``: ([e0, e1, e2] each f32[T, 8], nv f32[T, 12]),
    views of ``plucker_pack``'s columns."""
    pack = plucker_pack(tripack)
    return [pack[:, 8 * k:8 * k + 8] for k in range(3)], pack[:, 24:36]


# What a sweep derives from the scene swept last (the Plücker packs, the
# cull boxes), so that a render derives it once and not once per bounce:
# keyed by the storage, shape and version of the scene's triangle tensors,
# whose detached views the entry keeps alive (so no other tensor takes that
# storage while the key stands, and no autograd graph is pinned by it).
_scene_cache: dict = {}


def _scene_derived(scene, name, make):
    """``make()``, computed without autograd, cached under ``name`` while
    the scene's triangle tensors keep their storage and are not modified
    in place (a training step's new vertices rebuild it)."""
    leaves = tuple(x.detach() for x in (
        scene.tri_v0, scene.tri_v1, scene.tri_v2, scene.tri_valid,
        scene.tri_occluder))
    key = tuple((x.device, x.data_ptr(), tuple(x.shape), x._version)
                for x in leaves)
    if _scene_cache.get("key") != key:
        _scene_cache.clear()
        _scene_cache.update(key=key, leaves=leaves)
    if name not in _scene_cache:
        with torch.no_grad():
            _scene_cache[name] = make()
    return _scene_cache[name]


def scene_plucker_pack(scene, row_multiple: int = 1) -> torch.Tensor:
    """``plucker_pack`` of the scene's triangles, padded with zero rows to
    a multiple of ``row_multiple``; cached per scene."""
    def make():
        tripack = scene_tripack(scene)
        pad = (-tripack.shape[0]) % row_multiple
        if pad:
            tripack = torch.cat([tripack, tripack.new_zeros((pad, 12))])
        return plucker_pack(tripack)

    return _scene_derived(scene, ("plucker", row_multiple), make)


def block_aabbs(tripack: torch.Tensor, block: int,
                mask_col: int | None = None) -> torch.Tensor:
    """``_block_aabbs``: the AABB of every block of ``block`` rows of a
    [T, 12] pack, f32[C, 8] = min.xyz | max.xyz | 0 | 0 over the block's
    valid rows; an inverted box (min > max) for a block with none.
    ``mask_col`` names a pack column that must be > 0.5 besides valid, as in
    ``load_tile``: 10 for the rows a shadow sweep tests. A ragged last
    block counts the rows it has."""
    pad = (-tripack.shape[0]) % block
    if pad:
        tripack = torch.cat([tripack, tripack.new_zeros((pad, 12))])
    c = tripack.shape[0] // block
    tp = tripack.reshape(c, block, 12)
    use = tp[:, :, 9] > 0.5
    if mask_col is not None:
        use = use & (tp[:, :, mask_col] > 0.5)
    use = use[:, :, None, None]
    vs = tp[:, :, 0:9].reshape(c, block, 3, 3)    # [C, B, vertex, xyz]
    vmin = torch.where(use, vs, BIG).amin(dim=(1, 2))
    vmax = torch.where(use, vs, -BIG).amax(dim=(1, 2))
    return torch.cat([vmin, vmax, vmin.new_zeros((c, 2))], dim=1)


def aabb_cull_rows(aabb: torch.Tensor, o_rows, d_rows, bound):
    """``_aabb_cull_rows``: the slab test of boxes ``aabb`` [..., 8] against
    rays given as three origin and three direction rows, up to ``bound``.
    A box's column k, shaped [..., 1], broadcasts against the rows. Returns
    (hit, nonempty [..., 1]); a block is swept where both hold."""
    enter = exit_ = None
    for k in range(3):
        d_k = d_rows[k]
        tiny = torch.where(d_k >= 0, 1e-12, -1e-12).to(d_k.dtype)
        inv = 1.0 / torch.where(d_k.abs() < 1e-12, tiny, d_k)
        lo = (aabb[..., k:k + 1] - o_rows[k]) * inv
        hi = (aabb[..., k + 3:k + 4] - o_rows[k]) * inv
        tn, tf = torch.minimum(lo, hi), torch.maximum(lo, hi)
        enter = tn if enter is None else torch.maximum(enter, tn)
        exit_ = tf if exit_ is None else torch.minimum(exit_, tf)
    hit = (exit_ >= torch.clamp_min(enter, 0.0) - CULL_SLACK) & (
        enter <= bound + CULL_SLACK)
    return hit, aabb[..., 0:1] <= aabb[..., 3:4]


class CullBoxes(NamedTuple):
    """The boxes of a culled sweep over a [T, 12] pack: ``tile``
    f32[ceil(T / TILE_ROWS), 8] and ``group`` f32[ceil(T / CULL_GROUP), 8],
    over the rows the sweep tests (valid occluders for any-hit, every valid
    row for nearest), grown by ``CULL_PAD``."""

    tile: torch.Tensor
    group: torch.Tensor


def grow_boxes(aabb8: torch.Tensor) -> torch.Tensor:
    """Every non-empty box grown by CULL_PAD * max(1, |min|, |max|) per
    component. A box that holds another still holds it when both are
    grown."""
    lo, hi = aabb8[:, 0:3], aabb8[:, 3:6]
    nonempty = lo[:, 0:1] <= hi[:, 0:1]
    pad = CULL_PAD * torch.clamp_min(torch.maximum(lo.abs(), hi.abs()), 1.0)
    return torch.cat([torch.where(nonempty, lo - pad, lo),
                      torch.where(nonempty, hi + pad, hi), aabb8[:, 6:]],
                     dim=1).contiguous()


def cull_boxes(tripack: torch.Tensor,
               mask_col: int | None = OCCLUDER_COL) -> CullBoxes:
    """The tile and group boxes of a [T, 12] pack's shadow sweep, or, with
    ``mask_col`` None, over every valid row."""
    return CullBoxes(grow_boxes(block_aabbs(tripack, TILE_ROWS, mask_col)),
                     grow_boxes(block_aabbs(tripack, CULL_GROUP, mask_col)))


def nearest_cull_boxes(tripack: torch.Tensor) -> CullBoxes:
    """The tile and group boxes of a [T, 12] pack's nearest sweep: over
    every valid row, the mask of ``_block_aabbs``, so that a ray finds the
    light's rows, which are no occluders."""
    return cull_boxes(tripack, mask_col=None)


def scene_cull_boxes(scene) -> CullBoxes:
    """``cull_boxes`` of the scene's triangles, cached per scene."""
    return _scene_derived(scene, "cull",
                          lambda: cull_boxes(scene_tripack(scene)))


def scene_nearest_cull_boxes(scene) -> CullBoxes:
    """``nearest_cull_boxes`` of the scene's triangles, cached per scene
    beside the shadow sweep's."""
    return _scene_derived(scene, "nearest cull",
                          lambda: nearest_cull_boxes(scene_tripack(scene)))


def cull_pairs(cull: CullBoxes, lo: int, hi: int, o_rows, d_rows,
               bound) -> torch.Tensor:
    """bool[hi - lo, N]: the (row, lane) pairs of pack rows [lo, hi) that a
    culled sweep tests, which are those whose tile box and whose group box
    the lane's segment meets up to ``bound`` times ``CULL_REACH``."""
    keep = None
    bound = bound * CULL_REACH
    for boxes, block in ((cull.tile, TILE_ROWS), (cull.group, CULL_GROUP)):
        first = lo // block
        hit, nonempty = aabb_cull_rows(boxes[first:(hi - 1) // block + 1],
                                       o_rows, d_rows, bound)
        rows = torch.arange(lo, hi, device=boxes.device) // block - first
        meets = (hit & nonempty)[rows]
        keep = meets if keep is None else keep & meets
    return keep


def plucker_inside(s0, s1, s2):
    """Inside when the three edge side products have one sign."""
    return ((s0 >= 0.0) & (s1 >= 0.0) & (s2 >= 0.0)) | (
        (s0 <= 0.0) & (s1 <= 0.0) & (s2 <= 0.0))


def plucker_plane(pack: torch.Tensor, ox, oy, oz, dx, dy, dz):
    """The plane half of the Plücker test: (not parallel & t > T_MIN &
    valid, t) with t = n·(v0 - o) / (n·d), n unnormalized."""
    col = lambda c: pack[..., c:c + 1]
    nx, ny, nz = col(24), col(25), col(26)
    nd = nx * dx + ny * dy + nz * dz          # = -det of the classic form
    not_par = torch.abs(nd) > DET_EPS
    t = (nx * (col(27) - ox) + ny * (col(28) - oy)
         + nz * (col(29) - oz)) / torch.where(not_par, nd, 1.0)
    return not_par & (t > T_MIN) & (col(30) > 0.5), t


def plucker_rows(pack: torch.Tensor, ox, oy, oz, dx, dy, dz):
    """The Plücker test of [..., T, 36] pack rows against [..., 1, R] ray
    rows -> (hit [..., T, R] incl. the valid column, t [..., T, R]);
    ``_plucker_block``, with each side product written out as six products
    summed left to right (the two pad columns contribute nothing), which is
    the order of ``csrc/plucker.cuh``."""
    col = lambda c: pack[..., c:c + 1]
    # the ray's moment o x d, once per ray
    mx = oy * dz - oz * dy
    my = oz * dx - ox * dz
    mz = ox * dy - oy * dx

    def side(c):
        return (col(c) * mx + col(c + 1) * my + col(c + 2) * mz
                + col(c + 3) * dx + col(c + 4) * dy + col(c + 5) * dz)

    # pad and degenerate rows have all-zero sides, so they count as inside:
    # the plane's parallel test and the valid column are what rejects them
    plane, t = plucker_plane(pack, ox, oy, oz, dx, dy, dz)
    return plucker_inside(side(0), side(8), side(16)) & plane, t


class PairTest(NamedTuple):
    """A form of the ray-triangle test for the plain sweeps: ``rows(pack
    rows [..., T, cols], ox, oy, oz, dx, dy, dz) -> (hit, t)`` on its own
    pack layout, and the pack's occluder and valid columns."""

    rows: Callable
    occluder_col: int
    valid_col: int


CLASSIC = PairTest(mt_rows, 10, 9)
PLUCKER = PairTest(plucker_rows, 31, 30)


def chunk_rows(n_rays: int) -> int:
    """Triangle rows per plain-sweep chunk for ``n_rays`` lanes."""
    return max(1, PLAIN_CHUNK_ELEMS // max(n_rays, 1))


def nearest_t_idx_plain(o3: torch.Tensor, d3_unit: torch.Tensor,
                        tripack: torch.Tensor, pair: PairTest = CLASSIC,
                        cull: CullBoxes | None = None,
                        tested: list | None = None):
    """(t [N] — 0 on a miss, idx [N] int32 — -1 on a miss); ``tripack`` in
    the layout of ``pair``. Without ``cull`` every lane tests every row:
    the oracle. With ``cull`` (the ``nearest_cull_boxes`` of the [T, 12]
    pack of the same rows) it gives the culled kernel's result exactly, and
    ``tested`` gets the number of pairs it tests (``_nearest_culled``)."""
    if cull is not None:
        return _nearest_culled(o3, d3_unit, tripack, pair, cull, tested)
    n = o3.shape[1]
    rays = [o3[k:k + 1] for k in range(3)] + [d3_unit[k:k + 1] for k in range(3)]
    best_t = torch.full((1, n), BIG, dtype=o3.dtype, device=o3.device)
    best_idx = torch.full((1, n), -1, dtype=torch.int32, device=o3.device)
    step = chunk_rows(n)
    for lo in range(0, tripack.shape[0], step):
        hit, t = pair.rows(tripack[lo:lo + step], *rays)
        # the tile merge of intersect_pallas.py:_merge_nearest_tile: the
        # chunk minimum, the smallest index attaining it, then a strict <
        key = torch.where(hit, t, BIG)
        chunk_min = key.min(dim=0, keepdim=True).values
        gidx = torch.arange(lo, lo + key.shape[0], dtype=torch.int32,
                            device=o3.device)[:, None]
        cand = torch.where((key == chunk_min) & hit, gidx, IMAX)
        chunk_idx = cand.min(dim=0, keepdim=True).values
        better = (chunk_min < best_t) & (chunk_idx != IMAX)
        best_t = torch.where(better, chunk_min, best_t)
        best_idx = torch.where(better, chunk_idx, best_idx)
    idx = best_idx[0]
    return torch.where(idx >= 0, best_t[0], 0.0), idx


def _nearest_culled(o3, d3_unit, pack, pair: PairTest, cull: CullBoxes,
                    tested: list | None):
    """The culled nearest kernel's model: the groups of ``CULL_GROUP`` rows
    in index order, vectorised over lanes. A lane tests a group's valid
    rows only where its ray meets the group's box up to its running best t
    times ``CULL_REACH`` (``aabb_cull_rows``, float32), and takes a hit whose
    t is strictly below its best. Checking the group box alone is exact: a
    group met at its bound is met by its span, mid and tile too, which hold
    it and were tested at a bound no smaller, so the kernel tests the same
    pairs. Where the pair test is conditioned (|det| >= 1e-3 |e1||e2|) the
    winner is the un-culled sweep's; below that the pair test's t is noise
    and a culled sweep, here, on the card and in ``_nearest_kernel_cull``,
    can pass over a "hit" that the un-culled sweep takes."""
    n = o3.shape[1]
    o_rows = [o3[k:k + 1] for k in range(3)]
    d_rows = [d3_unit[k:k + 1] for k in range(3)]
    best_t = torch.full((1, n), BIG, dtype=o3.dtype, device=o3.device)
    best_idx = torch.full((1, n), -1, dtype=torch.int32, device=o3.device)
    valid = pack[:, pair.valid_col] > 0.5
    pad = (-pack.shape[0]) % CULL_GROUP
    per_group = torch.cat([valid, valid.new_zeros(pad)]).reshape(
        -1, CULL_GROUP).sum(dim=1)
    count = torch.zeros((), dtype=torch.int64, device=o3.device)
    step = max(1, chunk_rows(n) // CULL_GROUP) * CULL_GROUP
    for lo in range(0, pack.shape[0], step):
        hit, t = pair.rows(pack[lo:lo + step], *o_rows, *d_rows)
        for g0 in range(0, hit.shape[0], CULL_GROUP):
            g = (lo + g0) // CULL_GROUP
            meets, nonempty = aabb_cull_rows(cull.group[g:g + 1], o_rows,
                                             d_rows, best_t * CULL_REACH)
            meets = meets & nonempty
            count = count + meets.sum() * per_group[g]
            for r in range(g0, min(g0 + CULL_GROUP, hit.shape[0])):
                better = meets & hit[r:r + 1] & (t[r:r + 1] < best_t)
                best_t = torch.where(better, t[r:r + 1], best_t)
                best_idx = torch.where(better, lo + r, best_idx)
    if tested is not None:
        tested.append(int(count))
    idx = best_idx[0]
    return torch.where(idx >= 0, best_t[0], 0.0), idx


def check_input(name: str, x: torch.Tensor, device: torch.device,
                dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape``
    (None matches any extent) on ``device``."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if x.dim() != len(shape) or any(
        want is not None and got != want for got, want in zip(x.shape, shape)
    ):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def requires_grad(*tensors: torch.Tensor) -> bool:
    """Whether grad mode is on and any of ``tensors`` requires grad: the one
    test an entry makes before it calls its sweep directly."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in tensors)


def scene_vertices(scene) -> tuple:
    """The scene's triangle vertex tensors, the pack's differentiable
    columns."""
    return scene.tri_v0, scene.tri_v1, scene.tri_v2


def nearest_bwd(o3, d3_unit, tripack, idx, dt, needs=(True, True, True)):
    """The nearest sweeps' backward (``intersect_pallas.py:_nearest_bwd``):
    gather each lane's winning row of the [T, 12] ``tripack`` (the scene's
    rows, which every sweep's index names), re-solve t with
    ``intersect_moller`` and return (d o3, d d3_unit, d tripack) for the
    cotangent ``dt`` [N], each None where ``needs`` says it is not wanted.
    A miss (idx < 0) gets zero. One re-solve over the whole wavefront, so
    every sweep that finds the same winners gives the same gradients bit
    for bit. The rows' gradients are taken per lane and summed into the
    pack by ``ops.gather.scatter_rows``."""
    # ops.geometry imports this module
    from pathtracerpython_tpu_torch.ops.geometry import intersect_moller

    rows = idx.clamp_min(0).to(torch.int64)
    dt = torch.where(idx >= 0, dt, 0.0)
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(need) for x, need in zip(
            (o3, d3_unit, tripack.detach()[rows, 0:9]), needs)]
        o, d, w = leaves
        _, t = intersect_moller(o.T, d.T, w[:, 0:3], w[:, 3:6], w[:, 6:9])
        wanted = [x for x in leaves if x.requires_grad]
        grads = iter(torch.autograd.grad(t, wanted, dt) if wanted else ())
    d_o, d_d, d_w = (next(grads) if x.requires_grad else None
                     for x in leaves)
    if d_w is not None:
        d_w = torch.nn.functional.pad(
            scatter_rows(d_w, rows, tripack.shape[0]),
            (0, tripack.shape[1] - 9))
    return d_o, d_d, d_w


class NearestTIdx(torch.autograd.Function):
    """(t [N], idx [N]) of a nearest sweep with the JAX package's custom
    VJP: ``forward(o3, d3_unit, tripack, sweep)`` runs ``sweep(o3, d3)``,
    the kernel or its plain version, on detached rays (``sweep`` closes
    over a detached scene); ``backward`` is ``nearest_bwd``. ``tripack``
    is the scene's differentiable ``scene_tripack``."""

    @staticmethod
    def forward(ctx, o3, d3_unit, tripack, sweep):
        t, idx = sweep(o3.detach(), d3_unit.detach())
        ctx.save_for_backward(o3, d3_unit, tripack, idx)
        ctx.mark_non_differentiable(idx)
        return t, idx

    @staticmethod
    def backward(ctx, dt, _didx):
        o3, d3_unit, tripack, idx = ctx.saved_tensors
        return (*nearest_bwd(o3, d3_unit, tripack, idx, dt,
                             ctx.needs_input_grad[:3]), None)


def nearest_entry(sweep: Callable, o3: torch.Tensor, d3_unit: torch.Tensor,
                  scene):
    """``sweep(o3, d3_unit, scene) -> (t, idx)`` called directly where
    neither the rays nor the scene's vertices require grad, else under
    ``NearestTIdx`` with the scene detached for the sweep."""
    if not requires_grad(o3, d3_unit, *scene_vertices(scene)):
        return sweep(o3, d3_unit, scene)
    plain = scene.detach()
    return NearestTIdx.apply(o3, d3_unit, scene_tripack(scene),
                             lambda o, d: sweep(o, d, plain))


def detach_occlusion(o3, d3_unit, maxd, scene):
    """(o3, d3_unit, maxd, scene) as an any-hit sweep reads them: detached
    where any requires grad (occlusion is detached by design, the JAX
    package's ``stop_gradient`` on its any-hit inputs), else as given."""
    if not requires_grad(o3, d3_unit, maxd, *scene_vertices(scene)):
        return o3, d3_unit, maxd, scene
    return o3.detach(), d3_unit.detach(), maxd.detach(), scene.detach()


def nearest_t_idx_cm(o3: torch.Tensor, d3_unit: torch.Tensor, scene,
                     mt_impl: str | None = None,
                     cull: CullBoxes | None = None):
    """Closest forward hit of rays o3/d3_unit f32[3, N] (d3_unit of unit
    length) against the scene's triangles, in the form ``mt_impl`` (None:
    the module's ``MT_IMPL``). Returns (t [N] — 0 on a miss, idx [N] int32
    — -1 on a miss); t is differentiable in the rays and the vertices
    (``nearest_entry``). ``cull``: the scene's ``nearest_cull_boxes``, for a
    caller that keeps them itself (the geometry ring, whose shards change
    at every step); None takes them from the per-scene cache."""
    return nearest_entry(
        lambda o, d, sc: _nearest_t_idx(o, d, sc, mt_impl, cull), o3,
        d3_unit, scene)


def _sweep_pack(scene, plucker: bool, cached: bool) -> torch.Tensor:
    """The [T, 12] pack, or the [T, 36] Plücker pack (from the per-scene
    cache when ``cached``)."""
    if not plucker:
        return scene_tripack(scene)
    if cached:
        return scene_plucker_pack(scene)
    with torch.no_grad():
        return plucker_pack(scene_tripack(scene))


def _nearest_t_idx(o3, d3_unit, scene, mt_impl, cull=None):
    plucker = resolve_mt_impl(mt_impl) == "plucker"
    device = o3.device
    n = o3.shape[1] if o3.dim() == 2 else -1
    check_input("o3", o3, device, torch.float32, (3, None))
    check_input("d3_unit", d3_unit, device, torch.float32, (3, n))
    pack = _sweep_pack(scene, plucker, cull is None)
    check_input("scene triangles", pack, device, torch.float32,
                (None, PLUCKER_COLS if plucker else 12))
    if device.type == "cpu":
        plain = nearest_t_idx_plucker_plain if plucker else nearest_t_idx_plain
        return plain(o3, d3_unit, pack)
    if device.type != "cuda":
        raise ValueError(f"no nearest-hit kernel for device {device}")
    return (_launch_plucker if plucker else _launch)(
        o3, d3_unit, pack,
        scene_nearest_cull_boxes(scene) if cull is None else cull)


def _launch_nearest(o3, d3_unit, pack, entry: str, cull: CullBoxes,
                    stats: torch.Tensor | None = None):
    n = o3.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=o3.device)
    idx = torch.empty(n, dtype=torch.int32, device=o3.device)
    if n == 0:
        return t, idx, False
    fn = build.function(entry, _ARGTYPES)
    stream = torch.cuda.current_stream(o3.device).cuda_stream
    tile, group, counters = cull_pointers(cull, stats)
    err = fn(o3.data_ptr(), d3_unit.data_ptr(), n, pack.data_ptr(),
             pack.shape[0], tile, group, t.data_ptr(), idx.data_ptr(),
             counters, o3.device.index, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: kernel launch failed: CUDA error {err}")
    return t, idx, True


def _launch(o3, d3_unit, tripack, cull, stats=None):
    global LAUNCHES
    t, idx, launched = _launch_nearest(o3, d3_unit, tripack,
                                       "ptt_nearest_t_idx", cull, stats)
    LAUNCHES += launched
    return t, idx


def _launch_plucker(o3, d3_unit, pack36, cull, stats=None):
    global PLUCKER_LAUNCHES
    t, idx, launched = _launch_nearest(o3, d3_unit, pack36,
                                       "ptt_plucker_nearest_t_idx", cull,
                                       stats)
    PLUCKER_LAUNCHES += launched
    return t, idx


def any_hit_plain(o3: torch.Tensor, d3_unit: torch.Tensor,
                  maxd: torch.Tensor, tripack: torch.Tensor,
                  pair: PairTest = CLASSIC, cull: CullBoxes | None = None,
                  tested: list | None = None) -> torch.Tensor:
    """Occlusion bool[N] of rays o3/d3_unit within maxd, chunked over the
    occluder rows; ``tripack`` in the layout of ``pair``. Without ``cull``
    every lane meets every occluder: the oracle. With ``cull`` (the boxes
    of the [T, 12] pack of the same rows) a pair counts only where the
    culled kernel tests it, and ``tested`` gets each chunk's number of such
    pairs."""
    rays = [o3[k:k + 1] for k in range(3)] + [d3_unit[k:k + 1] for k in range(3)]
    occluder = tripack[:, pair.occluder_col] > 0.5
    rows = tripack[occluder] if cull is None else tripack
    limit = maxd[None, :] - T_MIN
    blocked = torch.zeros_like(limit, dtype=torch.bool)
    step = chunk_rows(o3.shape[1])
    for lo in range(0, rows.shape[0], step):
        hit, t = pair.rows(rows[lo:lo + step], *rays)
        blocking = hit & (t < limit)
        if cull is not None:
            keep = (cull_pairs(cull, lo, lo + hit.shape[0], rays[:3], rays[3:],
                               maxd[None, :])
                    & occluder[lo:lo + step, None] & (limit > T_MIN))
            blocking = blocking & keep
            if tested is not None:
                tested.append(int(keep.sum()))
        blocked = blocked | blocking.any(dim=0, keepdim=True)
    return blocked[0]


def nearest_t_idx_plucker_plain(o3, d3_unit, pack36):
    """K3's dense nearest sweep, plain: ``nearest_t_idx_plain``'s merge over
    ``plucker_rows`` of a ``plucker_pack``."""
    return nearest_t_idx_plain(o3, d3_unit, pack36, PLUCKER)


def any_hit_plucker_plain(o3, d3_unit, maxd, pack36, cull=None,
                          tested=None) -> torch.Tensor:
    """K3's dense any-hit, plain: ``any_hit_plain``'s merge over
    ``plucker_rows`` of a ``plucker_pack``."""
    return any_hit_plain(o3, d3_unit, maxd, pack36, PLUCKER, cull, tested)


def any_hit_cm(o3: torch.Tensor, d3_unit: torch.Tensor, maxd: torch.Tensor,
               scene, mt_impl: str | None = None,
               cull: CullBoxes | None = None) -> torch.Tensor:
    """Whether an occluder triangle of the scene blocks each shadow ray
    o3/d3_unit f32[3, N] (d3_unit of unit length) at t < maxd - 1e-4, in
    the form ``mt_impl`` (None: the module's ``MT_IMPL``); bool[N]. Lanes
    with maxd = 0 (parked) are never occluded. ``cull``: the scene's
    ``cull_boxes``, as ``nearest_t_idx_cm`` takes its own."""
    o3, d3_unit, maxd, scene = detach_occlusion(o3, d3_unit, maxd, scene)
    plucker = resolve_mt_impl(mt_impl) == "plucker"
    device = o3.device
    n = o3.shape[1] if o3.dim() == 2 else -1
    check_input("o3", o3, device, torch.float32, (3, None))
    check_input("d3_unit", d3_unit, device, torch.float32, (3, n))
    check_input("maxd", maxd, device, torch.float32, (n,))
    pack = _sweep_pack(scene, plucker, cull is None)
    check_input("scene triangles", pack, device, torch.float32,
                (None, PLUCKER_COLS if plucker else 12))
    if device.type == "cpu":
        plain = any_hit_plucker_plain if plucker else any_hit_plain
        return plain(o3, d3_unit, maxd, pack)
    if device.type != "cuda":
        raise ValueError(f"no any-hit kernel for device {device}")
    return (_launch_plucker_any_hit if plucker else _launch_any_hit)(
        o3, d3_unit, maxd, pack,
        scene_cull_boxes(scene) if cull is None else cull)


def cull_pointers(cull: CullBoxes, stats: torch.Tensor | None):
    """The (tile boxes, group boxes, stats) arguments of a culled
    kernel. ``stats``: an int64[3] CUDA tensor that the kernel's
    counting instance adds to (``cull_stats``), or None for the instance
    that only sweeps."""
    return (cull.tile.data_ptr(), cull.group.data_ptr(),
            None if stats is None else stats.data_ptr())


def cull_stats(stats: torch.Tensor, n: int, t_count: int) -> dict:
    """What the counting instance of a culled kernel added to ``stats`` in
    one launch over ``n`` lanes and ``t_count`` rows: the pairs it tested,
    and the shares of (block, tile) and (warp, group) steps it skipped, by
    the cull or because no lane was open any more."""
    staged, walked, pairs = stats.tolist()
    blocks = -(-n // TILE_ROWS)       # CTAs of TILE_ROWS lanes, 8 warps each
    tiles, groups = -(-t_count // TILE_ROWS), -(-t_count // CULL_GROUP)
    return {"pairs_tested": pairs,
            "tiles_skipped": 1.0 - staged / (blocks * tiles),
            "groups_skipped": 1.0 - walked / (blocks * 8 * groups)}


def _launch_occlusion(o3, d3_unit, maxd, pack, entry: str, cull: CullBoxes,
                      stats: torch.Tensor | None = None):
    n = o3.shape[1]
    occ = torch.empty(n, dtype=torch.bool, device=o3.device)
    if n == 0:
        return occ, False
    fn = build.function(entry, _ANY_HIT_ARGTYPES)
    stream = torch.cuda.current_stream(o3.device).cuda_stream
    tile, group, counters = cull_pointers(cull, stats)
    err = fn(o3.data_ptr(), d3_unit.data_ptr(), maxd.data_ptr(), n,
             pack.data_ptr(), pack.shape[0], tile, group, occ.data_ptr(),
             counters, o3.device.index, stream)
    if err != 0:
        raise RuntimeError(f"{entry}: kernel launch failed: CUDA error {err}")
    return occ, True


def _launch_any_hit(o3, d3_unit, maxd, tripack, cull, stats=None):
    global ANY_HIT_LAUNCHES
    occ, launched = _launch_occlusion(o3, d3_unit, maxd, tripack,
                                      "ptt_any_hit", cull, stats)
    ANY_HIT_LAUNCHES += launched
    return occ


def _launch_plucker_any_hit(o3, d3_unit, maxd, pack36, cull, stats=None):
    global PLUCKER_ANY_HIT_LAUNCHES
    occ, launched = _launch_occlusion(o3, d3_unit, maxd, pack36,
                                      "ptt_plucker_any_hit", cull, stats)
    PLUCKER_ANY_HIT_LAUNCHES += launched
    return occ
