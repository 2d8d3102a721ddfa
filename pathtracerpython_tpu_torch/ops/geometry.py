"""Closest-hit records and shadow occlusion on component-major [3, N]
tensors.

The fast branches of the JAX package's ``ops/geometry.py:nearest_hit_cm``
and ``any_hit_within_cm``: the hierarchy ``accel`` resolves to picks the
sweep (a CUDA kernel on the card, its plain version on the CPU):

    resolved accel   nearest sweep                  shadow any-hit
    "none"           K1 kernels/intersect.py        K4 kernels/intersect.py
    "sparse"         K5 kernels/sparse.py, r512     K6 kernels/sparse.py
    "walker"         K8 kernels/walker.py           K9 kernels/walker.py
    "hybrid"         K5 kernels/sparse.py, r1024    K9 kernels/walker.py

With ``nee_cache="on"`` the integrator replaces the sparse hierarchy's K6
by the occluder-cached K7 (``kernels/sparse.py:sparse_any_hit_cached_cm``).

``mt_impl`` (None: ``kernels.intersect.MT_IMPL``) picks the form of the
in-triangle test, "classic" or "plucker" (K3), in the sweeps that have
both: K1, K4, K5 and K6. The walker sweeps K8 and K9 are classic only, so
under "plucker" the hybrid runs the Plücker nearest sweep and the classic
K9, and the walker hierarchy is unchanged, as in the JAX package.

Reference mode (``mode="reference"``) takes the row-major sweeps below, as
the JAX package does: its ``nearest_hit_cm`` and ``any_hit_within_cm``
take the Pallas route only for ``mode == "fast"`` (``ops/geometry.py:338``,
``:419``) and fall to the XLA sweeps otherwise (``:388``, ``:447``). So
these are plain PyTorch, with no kernel. ``nearest_hit``,
``any_hit_within`` and ``first_occluder_index`` (JAX ``:152``, ``:242``,
``:453``) sweep the triangle buffer in tiles of ``TILE`` rows and the
lanes in chunks of ``LANE_CHUNK``, so that an intermediate is [LANE_CHUNK,
TILE]; neither changes a bit of the result. ``nearest_hit`` and
``any_hit_within`` keep JAX's fast mode too (its XLA form,
``intersect_moller``) as the row-major API JAX exposes; no render path of
the port takes it, since fast renders go through the kernels above. JAX's
``lax.dynamic_slice_in_dim`` shifts a last tile that overruns the buffer
back while the sweep names its rows from the unshifted start; here the
last tile is the rows it has.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pathtracerpython_tpu_torch.kernels.intersect import (
    any_hit_cm,
    nearest_t_idx_cm,
)
from pathtracerpython_tpu_torch.kernels.sparse import (
    R_BLK_HYBRID_NEAREST,
    resolve_accel,
    sparse_any_hit_cm,
    sparse_nearest_t_idx_cm,
)
from pathtracerpython_tpu_torch.kernels.walker import (
    walker_any_hit_cm,
    walker_nearest_t_idx_cm,
)
from pathtracerpython_tpu_torch.ops.gather import cm_take
from pathtracerpython_tpu_torch.scene.arrays import SceneTensors


# The reference's global epsilon (JAX ``ops/geometry.py:33``): the
# parallel-plane rejection, the self-hit exclusion on the SQUARED distance
# and the shadow test's slack.
ZERO = 1e-5
# Rows of the triangle buffer a sweep step takes (JAX's default ``tile``),
# and lanes a chunk holds: a 512^2 x 4 spp wavefront against one tile would
# be [2^20, 128] per intermediate, 0.5 GiB in float32; a chunk is 128 MiB.
TILE = 128
LANE_CHUNK = 1 << 18
IMAX = 2**31 - 1


def safe_normalize(v: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Normalize along the last axis; zero vectors map to zero."""
    sq = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    return v * torch.rsqrt(torch.clamp_min(sq, eps))[..., None]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1)


def intersect_moller(origin, direction, v0, v1, v2, eps: float = 1e-7):
    """Möller–Trumbore for broadcastable row-major [..., 3] rays and
    triangles, in the operation order of the JAX package's
    ``ops/geometry.py:intersect_moller`` (not the kernels' ``_mt_rows``
    order). ``direction`` normalized for a metric ``t``. Returns (hit, t),
    hit requiring t > 1e-4. Differentiable in every input: the nearest
    sweeps' backward re-solves each winner's t with it."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = torch.linalg.cross(direction, e2, dim=-1)
    det = _dot(e1, pvec)
    not_parallel = torch.abs(det) > eps
    inv_det = 1.0 / torch.where(not_parallel, det, 1.0)
    tvec = origin - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = torch.linalg.cross(tvec, e1, dim=-1)
    v = _dot(direction, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = not_parallel & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > 1e-4)
    return hit, t


def _cross(a, b):
    """``jnp.cross`` of component triples, component by component."""
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot3(a, b):
    """``jnp.sum(a * b, axis=-1)`` of component triples, in XLA's order."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _normalize(v, eps: float = 1e-30):
    """``safe_normalize`` of a component triple."""
    inv = torch.rsqrt(torch.clamp_min(_dot3(v, v), eps))
    return (v[0] * inv, v[1] * inv, v[2] * inv)


def _xyz(v: torch.Tensor):
    return v[..., 0], v[..., 1], v[..., 2]


def intersect_reference(origin, direction, v0, v1, v2):
    """Reference-semantics intersection of broadcastable row-major [..., 3]
    rays and triangles (JAX ``ops/geometry.py:47``). Returns (hit, t):
    ``t`` is the SIGNED distance along the normalized direction, with no
    t > 0 test (hits behind the origin count); ``hit`` excludes only
    near-parallel rays (|d.n| <= ZERO) and failed in-triangle tests. The
    plane normal is ``safe_normalize(cross(v0 - v1, v2 - v1))``, and the
    in-triangle test is sign-only: dot(c1, c2) > 0 and dot(c1, c3) > 0 of
    the three edge crosses. Written component by component in the order of
    JAX's ``jnp.cross`` and ``jnp.sum``, on one tensor per component."""
    o, d = _xyz(origin), _normalize(_xyz(direction))
    a, b, c = _xyz(v0), _xyz(v1), _xyz(v2)
    n = _normalize(_cross(_sub(a, b), _sub(c, b)))
    denom = _dot3(d, n)
    not_parallel = torch.abs(denom) > ZERO
    safe = torch.where(not_parallel, denom, 1.0)
    t = (_dot3(n, a) - _dot3(n, o)) / safe
    p = (o[0] + d[0] * t, o[1] + d[1] * t, o[2] + d[2] * t)
    c1 = _cross(_sub(a, b), _sub(p, b))
    c2 = _cross(_sub(b, c), _sub(p, c))
    c3 = _cross(_sub(c, a), _sub(p, a))
    inside = (_dot3(c1, c2) > 0.0) & (_dot3(c1, c3) > 0.0)
    return not_parallel & inside, t


def resolve_hit_attributes(scene: SceneTensors, tri_idx: torch.Tensor,
                           found: torch.Tensor):
    """(normal [..., 3], material, is_light) of the winning rows ``tri_idx``
    (JAX ``ops/geometry.py:99``) by plain index gathers; JAX's one-hot
    matmul variant is a TPU layout device."""
    rows = tri_idx.to(torch.int64)
    return (scene.tri_normal[rows], scene.tri_material[rows],
            scene.tri_is_light[rows] & found)


class NearestHit(NamedTuple):
    """Row-major nearest-hit record (masked lanes instead of None)."""

    hit: torch.Tensor       # bool[N] any triangle hit
    t: torch.Tensor         # f32[N] signed distance along the unit direction
    tri_idx: torch.Tensor   # i32[N] row of the triangle buffer, 0 on a miss
    point: torch.Tensor     # f32[N, 3]
    normal: torch.Tensor    # f32[N, 3] geometric (winding) normal
    material: torch.Tensor  # i32[N]
    is_light: torch.Tensor  # bool[N]


def _spans(n: int, step: int):
    """(start, stop) of each run of ``step`` of n items (tiles of rows,
    chunks of lanes); the last is ragged."""
    return [(s, min(s + step, n)) for s in range(0, n, step)]


def _pair_test(mode: str, o, d, rows):
    """(hit, t) [n, tile] of lanes (o, d) [n, 1, 3] against the triangle
    rows ``rows`` = (v0, v1, v2) [tile, 3] in ``mode``."""
    v0, v1, v2 = (v[None] for v in rows)
    if mode == "reference":
        return intersect_reference(o, d, v0, v1, v2)
    return intersect_moller(o, d, v0, v1, v2)


def _blocking(mode: str, hit, t, maxd):
    """Whether each (lane, row) pair's hit blocks a shadow ray of length
    ``maxd`` [n, 1]: in reference mode its squared distance lies in
    [ZERO, maxd^2) (backward hits block too), in fast mode t < maxd - 1e-4."""
    if mode == "reference":
        sq = t * t
        return hit & (sq >= ZERO) & (sq < maxd * maxd)
    return hit & (t < maxd - 1e-4)


def _check_mode(mode: str) -> None:
    if mode not in ("fast", "reference"):
        raise ValueError(f"mode={mode!r}")


@torch.no_grad()
def _nearest_sweep(origin, d_unit, scene: SceneTensors, mode: str):
    """(found, t, row) of the closest hit of each lane, without autograd."""
    n = origin.shape[0]
    big = torch.finfo(origin.dtype).max
    best_key = torch.full((n,), big, dtype=origin.dtype, device=origin.device)
    best_t = torch.zeros(n, dtype=origin.dtype, device=origin.device)
    best_idx = torch.zeros(n, dtype=torch.int32, device=origin.device)
    tris = (scene.tri_v0, scene.tri_v1, scene.tri_v2)
    for lo, hi in _spans(n, LANE_CHUNK):
        o, d = origin[lo:hi, None, :], d_unit[lo:hi, None, :]
        key_c, t_c, idx_c = best_key[lo:hi], best_t[lo:hi], best_idx[lo:hi]
        for start, stop in _spans(scene.num_padded_triangles, TILE):
            hit, t = _pair_test(mode, o, d, [v[start:stop] for v in tris])
            if mode == "reference":
                key = t * t
                hit = hit & (key > ZERO)
            else:
                key = t
            key = torch.where(hit & scene.tri_valid[None, start:stop], key,
                              big)
            arg = torch.argmin(key, dim=1, keepdim=True)
            tile_key = torch.gather(key, 1, arg)[:, 0]
            tile_t = torch.gather(t, 1, arg)[:, 0]
            better = tile_key < key_c
            key_c.copy_(torch.where(better, tile_key, key_c))
            t_c.copy_(torch.where(better, tile_t, t_c))
            idx_c.copy_(torch.where(better, arg[:, 0].to(torch.int32) + start,
                                    idx_c))
    return best_key < big, best_t, best_idx


def nearest_hit(origin: torch.Tensor, direction: torch.Tensor,
                scene: SceneTensors, mode: str = "fast",
                geom_axis: str | None = None) -> NearestHit:
    """Closest hit of [N] row-major rays against the whole padded triangle
    buffer (JAX ``ops/geometry.py:152``, its XLA sweep). The key is t in
    fast mode (``intersect_moller``, t > 1e-4) and t * t in reference mode
    (backward hits count; a hit needs key > ZERO). Padding is masked by
    ``tri_valid``; ties go to the smallest row: the first minimum within a
    tile, and a strict ``<`` across tiles. The light's rows come after the
    objects', so equal distances resolve as the reference's first-minimum
    ``min``.

    The sweep runs without autograd (its winners are discrete). Where grad
    is on and the rays or the vertices require it, each winner's t is
    solved again from its own row with autograd, and that solve's gradient
    is added to the sweep's t, whose value stays the sweep's bit for bit:
    the gradient JAX's ``where`` chain gives the winning pair.

    ``geom_axis``: sweep the geometry ring of that mesh axis
    (``parallel/ring.py``, JAX ``:171``), with global rows."""
    _check_mode(mode)
    if geom_axis is not None:
        hit = _ring_nearest(origin.T, direction.T, scene, geom_axis, mode,
                            None)
        return NearestHit(hit=hit.hit, t=hit.t, tri_idx=hit.tri_idx,
                          point=hit.point3.T, normal=hit.normal3.T,
                          material=hit.material, is_light=hit.is_light)
    d_unit = safe_normalize(direction)
    found, t, idx = _nearest_sweep(origin, d_unit, scene, mode)
    rows = idx.to(torch.int64)
    tris = (scene.tri_v0, scene.tri_v1, scene.tri_v2)
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (origin, direction, *tris)):
        solve = intersect_reference if mode == "reference" else \
            intersect_moller
        t_again = solve(origin, d_unit, *(v[rows] for v in tris))[1]
        t_again = torch.where(found, t_again, 0.0)
        t = t + (t_again - t_again.detach())
    point = origin + d_unit * t[:, None]
    normal, material, is_light = resolve_hit_attributes(scene, idx, found)
    return NearestHit(hit=found, t=t, tri_idx=idx, point=point,
                      normal=normal, material=material, is_light=is_light)


@torch.no_grad()
def any_hit_within(origin: torch.Tensor, direction: torch.Tensor,
                   max_dist: torch.Tensor, scene: SceneTensors,
                   mode: str = "fast",
                   geom_axis: str | None = None) -> torch.Tensor:
    """Shadow occlusion bool[N] (JAX ``ops/geometry.py:242``): does an
    occluder row (``tri_occluder``: the light never shadows) block the ray
    within ``max_dist`` [N], the euclidean distance to the light point? In
    reference mode a hit blocks when t * t lies in [ZERO, max_dist^2), so
    backward hits block too; in fast mode when t < max_dist - 1e-4.
    ``geom_axis``: over the geometry ring of that axis (JAX ``:265``)."""
    _check_mode(mode)
    if geom_axis is not None:
        return _ring_any_hit(origin.T, safe_normalize(direction).T, max_dist,
                             scene, geom_axis, mode, None)
    n = origin.shape[0]
    d_unit = safe_normalize(direction)
    occluded = torch.zeros(n, dtype=torch.bool, device=origin.device)
    tris = (scene.tri_v0, scene.tri_v1, scene.tri_v2)
    for lo, hi in _spans(n, LANE_CHUNK):
        o, d = origin[lo:hi, None, :], d_unit[lo:hi, None, :]
        maxd = max_dist[lo:hi, None]
        occ_c = occluded[lo:hi]
        for start, stop in _spans(scene.num_padded_triangles, TILE):
            hit, t = _pair_test(mode, o, d, [v[start:stop] for v in tris])
            blocking = (_blocking(mode, hit, t, maxd)
                        & scene.tri_occluder[None, start:stop])
            occ_c |= blocking.any(dim=1)
    return occluded


@torch.no_grad()
def first_occluder_index(origin: torch.Tensor, direction: torch.Tensor,
                         max_dist: torch.Tensor, scene: SceneTensors,
                         geom_axis: str | None = None):
    """(row, material) of the FIRST occluder in buffer order that blocks
    each ray within ``max_dist``, (-1, 0) where none does (JAX
    ``ops/geometry.py:453``). It reproduces the reference's leaked loop
    variable: the direct light's colour is that of the object that blocked
    the LAST light sample, the first one its occlusion scan met; pack order
    keeps the reference's object order, with the light, never scanned,
    last. Reference mode only: nothing else shades with it.
    ``geom_axis``: over the geometry ring of that axis, with global rows
    (JAX ``:475``)."""
    if geom_axis is not None:
        from pathtracerpython_tpu_torch.parallel.ring import (
            first_occluder_ring,
        )

        return first_occluder_ring(origin, direction, max_dist, scene,
                                   geom_axis)
    n = origin.shape[0]
    d_unit = safe_normalize(direction)
    best = torch.full((n,), IMAX, dtype=torch.int32, device=origin.device)
    tris = (scene.tri_v0, scene.tri_v1, scene.tri_v2)
    for lo, hi in _spans(n, LANE_CHUNK):
        o, d = origin[lo:hi, None, :], d_unit[lo:hi, None, :]
        maxd = max_dist[lo:hi, None]
        best_c = best[lo:hi]
        for start, stop in _spans(scene.num_padded_triangles, TILE):
            hit, t = _pair_test("reference", o, d, [v[start:stop] for v in tris])
            blocking = (_blocking("reference", hit, t, maxd)
                        & scene.tri_occluder[None, start:stop])
            rows = torch.arange(start, stop, dtype=torch.int32,
                                device=origin.device)
            cand = torch.where(blocking, rows[None, :], IMAX)
            best_c.copy_(torch.minimum(best_c, cand.amin(dim=1)))
    found = best != IMAX
    material = scene.tri_material[torch.where(found, best, 0).to(torch.int64)]
    return (torch.where(found, best, -1),
            torch.where(found, material, 0))


def normalize3(v3: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Normalize along axis 0 of a component-major [3, ...] tensor."""
    sq = v3[0] * v3[0] + v3[1] * v3[1] + v3[2] * v3[2]
    return v3 * torch.rsqrt(torch.clamp_min(sq, eps))[None]


class NearestHitCM(NamedTuple):
    """Component-major nearest-hit record: vectors are [3, N]."""

    hit: torch.Tensor       # bool[N]
    t: torch.Tensor         # f32[N]  0 on a miss
    tri_idx: torch.Tensor   # i32[N]  0 on a miss
    point3: torch.Tensor    # f32[3, N]
    normal3: torch.Tensor   # f32[3, N]  geometric (winding) normal
    material: torch.Tensor  # i32[N]
    is_light: torch.Tensor  # bool[N]


def nearest_hit_cm(o3: torch.Tensor, d3: torch.Tensor, scene: SceneTensors,
                   accel: str = "none", mt_impl: str | None = None,
                   mode: str = "fast",
                   geom_axis: str | None = None) -> NearestHitCM:
    """Closest hit of rays (o3, d3) [3, N] against the scene's triangles,
    through the sweep ``accel`` resolves to; ``d3`` need not be
    normalized. Every sweep gives the dense sweep's winner in its form.
    ``mode="reference"`` takes the row-major reference sweep
    (``nearest_hit``), whatever ``accel`` and ``mt_impl`` say, as the JAX
    package does. ``geom_axis``: the geometry ring of that axis
    (``parallel/ring.py``: K1 on each shard in fast mode, the reference
    sweep in reference mode; ``accel`` is not read, as in JAX ``:338``),
    with global rows."""
    if geom_axis is not None:
        return _ring_nearest(o3, d3, scene, geom_axis, mode, mt_impl)
    if mode != "fast":
        hit = nearest_hit(o3.T, d3.T, scene, mode=mode)
        return NearestHitCM(hit=hit.hit, t=hit.t, tri_idx=hit.tri_idx,
                            point3=hit.point.T, normal3=hit.normal.T,
                            material=hit.material, is_light=hit.is_light)
    d3u = normalize3(d3)
    resolved = resolve_accel(accel, scene.num_padded_triangles)
    if resolved == "hybrid":
        t, idx = sparse_nearest_t_idx_cm(o3, d3u, scene,
                                         r_blk=R_BLK_HYBRID_NEAREST,
                                         mt_impl=mt_impl)
    elif resolved == "sparse":
        t, idx = sparse_nearest_t_idx_cm(o3, d3u, scene, mt_impl=mt_impl)
    elif resolved == "walker":
        t, idx = walker_nearest_t_idx_cm(o3, d3u, scene)
    else:
        t, idx = nearest_t_idx_cm(o3, d3u, scene, mt_impl=mt_impl)
    found = idx >= 0
    safe_idx = idx.clamp_min(0)
    point3 = o3 + d3u * t[None, :]
    rows = safe_idx.to(torch.int64)
    return NearestHitCM(
        hit=found,
        t=t,
        tri_idx=safe_idx,
        point3=point3,
        normal3=cm_take(scene.tri_normal.T, rows),
        material=scene.tri_material[rows],
        is_light=scene.tri_is_light[rows] & found,
    )


def any_hit_within_cm(o3: torch.Tensor, d3_unit: torch.Tensor,
                      max_dist: torch.Tensor, scene: SceneTensors,
                      accel: str = "none", mt_impl: str | None = None,
                      mode: str = "fast",
                      geom_axis: str | None = None) -> torch.Tensor:
    """Shadow occlusion bool[N] of rays (o3, d3_unit) [3, N] within
    ``max_dist`` [N], through the any-hit ``accel`` resolves to;
    ``d3_unit`` must be normalized. ``mode="reference"`` takes the
    row-major reference sweep (``any_hit_within``); ``geom_axis`` the
    geometry ring of that axis (K4 on each shard in fast mode; JAX
    ``:419``)."""
    if geom_axis is not None:
        return _ring_any_hit(o3, d3_unit, max_dist, scene, geom_axis, mode,
                             mt_impl)
    if mode != "fast":
        return any_hit_within(o3.T, d3_unit.T, max_dist, scene, mode=mode)
    resolved = resolve_accel(accel, scene.num_padded_triangles)
    if resolved == "sparse":
        return sparse_any_hit_cm(o3, d3_unit, max_dist, scene,
                                 mt_impl=mt_impl)
    if resolved in ("walker", "hybrid"):
        return walker_any_hit_cm(o3, d3_unit, max_dist, scene)
    return any_hit_cm(o3, d3_unit, max_dist, scene, mt_impl=mt_impl)


def _ring_nearest(o3, d3, scene, axis, mode, mt_impl) -> NearestHitCM:
    # parallel.ring imports this module
    from pathtracerpython_tpu_torch.parallel.ring import nearest_hit_ring

    return nearest_hit_ring(o3, d3, scene, axis, mode=mode, mt_impl=mt_impl)


def _ring_any_hit(o3, d3_unit, max_dist, scene, axis, mode, mt_impl):
    from pathtracerpython_tpu_torch.parallel.ring import any_hit_ring

    return any_hit_ring(o3, d3_unit, max_dist, scene, axis, mode=mode,
                        mt_impl=mt_impl)
