"""Primary-ray generation (pinhole through an ortho window on z=0).

Contract (the JAX package's ``ops/camera.py``): screen points lie on the
z=0 plane at (x, y, 0), x from an inclusive linspace over (x0, x1) as the
OUTER loop and y over (y0, y1) as the INNER loop, so the flat pixel index
is ``ix * height + iy``; rays are (eye, screen_pt - eye), directions NOT
normalized.
"""

from __future__ import annotations

import torch

# Below this many points XLA:CPU evaluates jnp.linspace in scalar code;
# from here on it runs a vector body over the first 32*k points.
_XLA_VECTOR_MIN = 353
_XLA_VECTOR_LANES = 32
_XLA_UNROLLED_MAX = 33  # largest div XLA:CPU unrolls in full


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c as a fused multiply-add: the float64 product of two
    float32 values is exact, and the float64 sum rounds to the same
    float32 unless it lands exactly on a float32 rounding midpoint."""
    return (a.double() * b.double() + c.double()).float()


def linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """Inclusive float32 linspace with the bits ``jnp.linspace`` gives on
    the CPU, where the render's reference runs.

    JAX computes ``start*(1 - i/div) + stop*(i/div)``; XLA rewrites it to
    ``start*(1 - i*c) + i*(stop*c)`` with c = float32(1/div) and contracts
    the final add into a fused multiply-add, and in its vector body also
    ``1 - i*c``. ``torch.linspace`` and ``np.linspace`` round differently,
    and one ulp in a screen point moves the ray. The last point is
    ``stop`` exactly."""
    start = start.to(torch.float32)
    stop = stop.to(torch.float32)
    if num == 1:
        return start.reshape(1)
    div = num - 1
    c = torch.ones((), dtype=torch.float32, device=start.device) / div
    i = torch.arange(div, dtype=torch.float32, device=start.device)
    one_minus = 1.0 - i * c
    if num >= _XLA_VECTOR_MIN:
        body = (div // _XLA_VECTOR_LANES) * _XLA_VECTOR_LANES
        one_minus_fma = _fma32(-i, c.expand_as(i), torch.ones_like(i))
        one_minus = torch.cat([one_minus_fma[:body], one_minus[body:]])
    step = stop * c
    out = _fma32(i, step.expand_as(i), start * one_minus)
    if 2 <= div <= _XLA_UNROLLED_MAX:
        # fully unrolled scalar code folds i*(stop*c) at i == 1 and fuses
        # the other product instead
        out[1] = _fma32(start, one_minus[1], step)
    return torch.cat([out, stop.reshape(1)])


def make_screen_points(ortho: torch.Tensor, width: int,
                       height: int) -> torch.Tensor:
    """Screen sample points, [width*height, 3], x-outer / y-inner order."""
    xs = linspace(ortho[0], ortho[2], width)
    ys = linspace(ortho[1], ortho[3], height)
    x = xs.repeat_interleave(height)
    y = ys.repeat(width)
    return torch.stack([x, y, torch.zeros_like(x)], dim=-1)


def make_primary_rays(
    eye: torch.Tensor, ortho: torch.Tensor, width: int, height: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Primary rays: (origins [W*H, 3], unnormalized directions [W*H, 3])."""
    pts = make_screen_points(ortho, width, height)
    origins = eye.expand(pts.shape)
    return origins, pts - eye
