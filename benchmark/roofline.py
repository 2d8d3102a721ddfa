"""The card's published peaks and the least time a sweep's work could take.

The bounds count the work the cell's traffic needs, whatever implements it:
the rays the integrator hands the sweep each bounce, read once; the outputs,
written once; the scene's triangles, read once; over the memory rate, or the
operations over the float32 peak, whichever is larger. Candidate lists and
culling tables that one implementation builds are not counted.
"""

from __future__ import annotations

# NVIDIA H100 SXM at 700 W (data sheet): float32 outside the tensor cores,
# and HBM3's rate.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Float adds, subtracts, multiplies and divides of one Moller-Trumbore
# ray-triangle test: pvec 9, det 5, 1/det 1, tvec 3, u 6, qvec 9, v 6, t 6,
# u + v 1. A lane needs at least one test: its winner's, or its blocker's.
FLOPS_PER_PAIR = 46
F32 = 4
RAY_IN = 6 * F32            # origin and direction
NEAREST_OUT = 2 * F32       # t and the winning row
SHADOW_IN = 7 * F32         # origin, direction and the light's distance
SHADOW_OUT = 1              # the occlusion bit, a byte
TRIANGLE = 9 * F32          # three vertices


def nearest_bytes(lanes: int, triangles: int) -> int:
    """Bytes one nearest sweep of ``lanes`` rays must move."""
    return lanes * (RAY_IN + NEAREST_OUT) + triangles * TRIANGLE


def anyhit_bytes(rays: int, triangles: int) -> int:
    """Bytes one any-hit sweep of ``rays`` shadow rays must move."""
    return rays * (SHADOW_IN + SHADOW_OUT) + triangles * TRIANGLE


def bound_s(nbytes: int, pairs: int) -> float:
    """The least seconds the card could take: bytes over the memory rate
    or the pair tests' operations over the float32 peak."""
    return max(nbytes / PEAK_BYTES_PER_S,
               pairs * FLOPS_PER_PAIR / PEAK_FP32_FLOPS)


def sweep_bounds(work: dict) -> dict:
    """Seconds of the least time of the nearest and the any-hit sweeps of
    one unit of work (a chunk or a step): ``work`` has the lanes a bounce,
    the bounces, the light samples a bounce and the scene's triangles."""
    lanes, b, s, tris = (work["lanes"], work["bounces"],
                         work["light_samples"], work["triangles"])
    return {
        "nearest": b * bound_s(nearest_bytes(lanes, tris), lanes),
        "anyhit": b * bound_s(anyhit_bytes(lanes * s, tris), lanes * s),
    }
