"""Closest-hit records on component-major [3, N] tensors.

The fast dense branch of the JAX package's ``ops/geometry.py:nearest_hit_cm``:
normalize the directions, run the nearest-hit sweep (the K1 kernel on the
card, its plain version on the CPU), and resolve the winner's attributes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pathtracerpython_tpu_torch.kernels.intersect import nearest_t_idx_cm
from pathtracerpython_tpu_torch.ops.gather import cm_take
from pathtracerpython_tpu_torch.scene.arrays import SceneTensors


def safe_normalize(v: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Normalize along the last axis; zero vectors map to zero."""
    sq = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]
    return v * torch.rsqrt(torch.clamp_min(sq, eps))[..., None]


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


def nearest_hit_cm(o3: torch.Tensor, d3: torch.Tensor,
                   scene: SceneTensors) -> NearestHitCM:
    """Dense closest hit of rays (o3, d3) [3, N] against every triangle;
    ``d3`` need not be normalized."""
    d3u = normalize3(d3)
    t, idx = nearest_t_idx_cm(o3, d3u, scene)
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
