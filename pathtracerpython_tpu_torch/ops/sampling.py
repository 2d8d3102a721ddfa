"""Monte-Carlo sampling primitives on component-major [3, ...] tensors.

Same math, in the same operation order, as the ``cm_*`` functions and
``pick_light_triangle`` of the JAX package's ``ops/sampling.py`` (fast
mode only; the reference-mode samplers come with the reference estimator).
"""

from __future__ import annotations

import math

import torch

TAU = 2.0 * math.pi


def pick_light_triangle(u: torch.Tensor, areas: torch.Tensor) -> torch.Tensor:
    """Area-proportional triangle pick by CDF inversion: the index i with
    cum[i-1] <= u * total < cum[i]. ``u``: uniforms in [0, 1), any shape.
    Returns int32 indices."""
    cum = torch.cumsum(areas, dim=0)
    x = u * cum[-1]
    idx = torch.searchsorted(cum, x.contiguous(), right=True)
    return idx.clamp(0, areas.shape[0] - 1).to(torch.int32)


def cm_dot(a3: torch.Tensor, b3: torch.Tensor) -> torch.Tensor:
    return a3[0] * b3[0] + a3[1] * b3[1] + a3[2] * b3[2]


def cm_normalize(v3: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    sq = cm_dot(v3, v3)[None]
    return v3 * torch.rsqrt(torch.clamp_min(sq, eps))


def cm_sample_barycentric_uniform(u2: torch.Tensor) -> torch.Tensor:
    """u2 [2, ...] -> [3, ...] uniform over the triangle (sqrt trick)."""
    su = torch.sqrt(u2[0])
    return torch.stack([1.0 - su, su * (1.0 - u2[1]), su * u2[1]])


def cm_point_from_barycentric(bary, v0, v1, v2) -> torch.Tensor:
    """All [3, ...]: bary-weighted combination."""
    return bary[0][None] * v0 + bary[1][None] * v1 + bary[2][None] * v2


def cm_build_onb(n3: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Branchless orthonormal basis (Duff et al. 2017) around n3."""
    sign = torch.where(n3[2] >= 0.0, 1.0, -1.0).to(n3.dtype)
    a = -1.0 / (sign + n3[2])
    b = n3[0] * n3[1] * a
    t3 = torch.stack([
        1.0 + sign * (n3[0] * n3[0]) * a, sign * b, -sign * n3[0],
    ])
    b3 = torch.stack([b, sign + (n3[1] * n3[1]) * a, -n3[1]])
    return t3, b3


def cm_cosine_hemisphere_fixed(u2: torch.Tensor, n3: torch.Tensor):
    """Cosine-weighted hemisphere about n3; u2 [2, ...], n3 [3, ...]."""
    r = torch.sqrt(u2[0])
    theta = TAU * u2[1]
    x = r * torch.cos(theta)
    y = r * torch.sin(theta)
    z = torch.sqrt(torch.clamp_min(1.0 - u2[0], 0.0))
    t3, b3 = cm_build_onb(n3)
    return cm_normalize(x[None] * t3 + y[None] * b3 + z[None] * n3)


def cm_reflect(d3: torch.Tensor, n3: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of an incoming direction."""
    return d3 - 2.0 * cm_dot(d3, n3)[None] * n3
