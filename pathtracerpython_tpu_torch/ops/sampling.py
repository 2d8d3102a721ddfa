"""Monte-Carlo sampling primitives on component-major [3, ...] tensors.

Same math, in the same operation order, as the functions of the JAX
package's ``ops/sampling.py``: the fast-mode ``cm_*`` samplers and
``pick_light_triangle``, and the reference estimator's samplers, which
reproduce the reference program's quirks on purpose (its 2pi truncated to
6.28, centre-biased barycentrics, tangent frames rotated about the fixed
y axis), each in its row-major form and its ``cm_`` form. The two forms of
the frame rotation differ as JAX's do: the row-major matrix's middle row is
aa + cc, while ``cm_rotate_frame_reference`` passes v[1] through.
"""

from __future__ import annotations

import math

import torch

TAU = 2.0 * math.pi
# The reference truncates 2pi to 6.28 (JAX ``ops/sampling.py:21``): its
# azimuths never cover the last ~3.2 mrad. Reference mode only.
TAU_REFERENCE = 6.28


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


def sample_barycentric_reference(u3: torch.Tensor) -> torch.Tensor:
    """The reference's barycentrics (JAX ``ops/sampling.py:50``): three
    uniforms [..., 3] divided by their sum, NOT uniform over the triangle
    (centre-biased)."""
    total = u3[..., 0] + u3[..., 1] + u3[..., 2]
    return u3 / total[..., None]


def point_from_barycentric(bary, v0, v1, v2) -> torch.Tensor:
    """[..., 3] point a*v0 + b*v1 + c*v2 (JAX ``ops/sampling.py:68``)."""
    return bary[..., 0:1] * v0 + bary[..., 1:2] * v1 + bary[..., 2:3] * v2


def rotation_about_y(angle: torch.Tensor) -> torch.Tensor:
    """The reference's quaternion rotation matrix about the axis (0, 1, 0)
    (JAX ``ops/sampling.py:75``): a = cos(angle/2), c = -sin(angle/2).
    Returns [..., 3, 3] acting on column vectors."""
    a = torch.cos(angle / 2.0)
    c = -torch.sin(angle / 2.0)
    aa, cc, ac = a * a, c * c, a * c
    zero = torch.zeros_like(a)
    row0 = torch.stack([aa - cc, zero, -2 * ac], dim=-1)
    row1 = torch.stack([zero, aa + cc, zero], dim=-1)
    row2 = torch.stack([2 * ac, zero, aa - cc], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotate_frame_reference(v: torch.Tensor,
                           normal: torch.Tensor) -> torch.Tensor:
    """The reference's tangent frame (JAX ``ops/sampling.py:91``): rotate
    ``v`` [..., 3] about the FIXED y axis by arccos(normal_y), so only
    y-facing surfaces get a right frame. R @ v summed over j in order, as
    the einsum of three terms at HIGHEST precision."""
    angle = torch.arccos(torch.clamp(normal[..., 1], -1.0, 1.0))
    rot = rotation_about_y(angle)
    return (rot[..., 0] * v[..., 0:1] + rot[..., 1] * v[..., 1:2]
            + rot[..., 2] * v[..., 2:3])


def cosine_hemisphere_reference(u2: torch.Tensor) -> torch.Tensor:
    """The reference's canonical cosine sample about +z (JAX
    ``ops/sampling.py:104``): phi = arccos(sqrt(u1)), theta = 6.28 * u2,
    (sin phi cos theta, sin phi sin theta, cos phi). ``u2`` [..., 2]."""
    phi = torch.arccos(torch.sqrt(u2[..., 0]))
    theta = TAU_REFERENCE * u2[..., 1]
    sp = torch.sin(phi)
    return torch.stack([sp * torch.cos(theta), sp * torch.sin(theta),
                        torch.cos(phi)], dim=-1)


def cm_sample_barycentric_reference(u3: torch.Tensor) -> torch.Tensor:
    """u3 [3, ...] -> barycentrics [3, ...]: normalized uniforms (JAX
    ``ops/sampling.py:180``)."""
    return u3 / (u3[0] + u3[1] + u3[2])[None]


def cm_cosine_hemisphere_reference(u2: torch.Tensor) -> torch.Tensor:
    """The reference's canonical cosine sample, [3, ...] (JAX
    ``ops/sampling.py:196``)."""
    phi = torch.arccos(torch.sqrt(u2[0]))
    theta = TAU_REFERENCE * u2[1]
    sp = torch.sin(phi)
    return torch.stack([sp * torch.cos(theta), sp * torch.sin(theta),
                        torch.cos(phi)])


def cm_rotate_frame_reference(v3: torch.Tensor,
                              n3: torch.Tensor) -> torch.Tensor:
    """The reference's y-axis frame rotation, component-major (JAX
    ``ops/sampling.py:204``): rows [aa-cc, 0, -2ac], [0, 1, 0],
    [2ac, 0, aa-cc], so v[1] passes through."""
    angle = torch.arccos(torch.clamp(n3[1], -1.0, 1.0))
    a = torch.cos(angle / 2.0)
    c = -torch.sin(angle / 2.0)
    aa_cc = a * a - c * c
    two_ac = 2.0 * a * c
    return torch.stack([aa_cc * v3[0] - two_ac * v3[2], v3[1],
                        two_ac * v3[0] + aa_cc * v3[2]])
