"""Wavefront ray ordering for the cluster hierarchy.

The per-block candidate lists (kernels/sparse.py, kernels/walker.py) are
the union of the clusters any ray of a block can touch, so they are only
as short as the block is coherent. The integrator re-sorts the wavefront
every bounce by a (direction octant, origin morton, direction morton) key,
putting rays with similar frustums into the same block; dead lanes sort to
the end and are parked on a ray that touches no cluster.

A pure permutation of independent lanes: every per-lane quantity (the RNG
counter included) travels with its ray, so a sorted render equals an
unsorted one. The permutation equals ``ops/sort.py`` of the JAX package
bit for bit: PyTorch has no shifts on uint32, so the 32-bit keys ride in
int64 tensors (as in ``ops/rng.py``), and the argsort is stable, as
``jnp.argsort`` is.
"""

from __future__ import annotations

import torch

# Dead lanes are parked on a ray far above every scene pointing away from
# it: their blocks get empty candidate lists.
PARK_ORIGIN = (0.0, 1.0e6, 0.0)
PARK_DIR = (0.0, 1.0, 0.0)

_ORIGIN_BITS = 5  # per axis
_DIR_BITS = 4     # per axis
# key layout (30 bits): [octant 3][origin morton 15][direction morton 12];
# bit 30 carries the optional occlusion hint, 0xFFFFFFFF marks dead lanes.
_DEAD_KEY = 0xFFFFFFFF


def _spread3(x: torch.Tensor) -> torch.Tensor:
    """Interleave zeros between the low 10 bits of each (int64) lane."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton3(q3: torch.Tensor) -> torch.Tensor:
    """Z-order key of quantized coordinates q3 int64[3, N] (each < 2^10)."""
    return (_spread3(q3[0]) << 2) | (_spread3(q3[1]) << 1) | _spread3(q3[2])


def scene_bounds(scene) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo3, hi3) of the valid triangles' vertices, detached: they only
    order lanes."""
    valid = scene.tri_valid[:, None]
    vs = torch.cat([scene.tri_v0, scene.tri_v1, scene.tri_v2],
                   dim=0).detach()
    vmask = torch.cat([valid] * 3, dim=0)
    lo = torch.where(vmask, vs, torch.inf).amin(dim=0)
    hi = torch.where(vmask, vs, -torch.inf).amax(dim=0)
    return lo, hi


def wavefront_sort_order(o3, d3, alive, lo3, hi3,
                         occ_hint=None) -> torch.Tensor:
    """Permutation int64[N] sorting rays by (direction octant, origin
    morton, direction morton); dead lanes sort to the end. ``occ_hint``
    bool[N] (optional) puts predicted-occluded lanes first (bit 30). The
    keys are discrete, so the rays are read detached."""
    o3, d3 = o3.detach(), d3.detach()
    span = torch.clamp_min(hi3 - lo3, 1e-12)[:, None]
    oscale = float(2**_ORIGIN_BITS) - 1.0
    oq = torch.clamp((o3 - lo3[:, None]) / span * oscale, 0.0, oscale)
    oq = oq.to(torch.int64)

    sq = d3[0] * d3[0] + d3[1] * d3[1] + d3[2] * d3[2]
    d3n = d3 * torch.rsqrt(torch.clamp_min(sq, 1e-30))[None]
    dscale = float(2**_DIR_BITS) - 1.0
    dq = torch.clamp((d3n + 1.0) * 0.5 * dscale, 0.0, dscale).to(torch.int64)

    neg = (d3 < 0).to(torch.int64)
    octant = (neg[0] << 2) | (neg[1] << 1) | neg[2]
    key = (
        (octant << (3 * (_ORIGIN_BITS + _DIR_BITS)))
        | (morton3(oq) << (3 * _DIR_BITS))
        | morton3(dq)
    )
    if occ_hint is not None:
        key = key | torch.where(occ_hint, 0, 1 << 30)
    key = torch.where(alive, key, _DEAD_KEY)
    return torch.argsort(key, stable=True)


def permute_minor(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Gather along the lane (last) axis."""
    return x.index_select(x.dim() - 1, order)


def unpermute_minor(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """The inverse of ``permute_minor``: lane ``order[i]`` of the result
    is lane ``i`` of ``x``."""
    out = torch.empty_like(x)
    out[..., order] = x
    return out
