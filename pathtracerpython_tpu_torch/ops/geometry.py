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
                   accel: str = "none",
                   mt_impl: str | None = None) -> NearestHitCM:
    """Closest hit of rays (o3, d3) [3, N] against the scene's triangles,
    through the sweep ``accel`` resolves to; ``d3`` need not be
    normalized. Every sweep gives the dense sweep's winner in its form."""
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
                      accel: str = "none",
                      mt_impl: str | None = None) -> torch.Tensor:
    """Shadow occlusion bool[N] of rays (o3, d3_unit) [3, N] within
    ``max_dist`` [N], through the any-hit ``accel`` resolves to;
    ``d3_unit`` must be normalized."""
    resolved = resolve_accel(accel, scene.num_padded_triangles)
    if resolved == "sparse":
        return sparse_any_hit_cm(o3, d3_unit, max_dist, scene,
                                 mt_impl=mt_impl)
    if resolved in ("walker", "hybrid"):
        return walker_any_hit_cm(o3, d3_unit, max_dist, scene)
    return any_hit_cm(o3, d3_unit, max_dist, scene, mt_impl=mt_impl)
