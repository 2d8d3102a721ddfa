"""K2: the fused fast-mode NEE — CUDA kernel wrapper and plain version.

``nee_mean_cos_fused`` has the signature of the JAX package's
``kernels/nee_pallas.py:nee_mean_cos_fused`` and returns the mean
unoccluded cosine [1, N] together with the occlusion bits [S, N] (0/1
float). On a CUDA tensor it launches ``csrc/nee.cu`` (or raises); on a CPU
tensor it runs ``nee_mean_cos_plain``, which follows ``_nee_body``
operation by operation: compare-and-count light pick on the cumulative
areas, sqrt-trick barycentrics from uniform rows 5s+1 and 5s+2, direction
by rsqrt(max(sq, 1e-30)) and distance by sqrt(sq + 1e-24), clamped
cosine, occluder sweep with t < dist - 1e-4, then the mean. Forward only.
Its occluder sweep is classic Möller–Trumbore whatever the ``MT_IMPL`` knob
of ``kernels/intersect.py`` says: ``nee_pallas.py`` has no Plücker body.
The kernel culls the sweep by the tile and group boxes of
``kernels/intersect.py:scene_cull_boxes``, per sample, with the sample's
distance as the bound (``_nee_body`` under ``cull=True``);
``nee_mean_cos_plain`` without ``cull`` is the oracle, with ``cull`` it
masks pairs as the kernel does. The bits are the same.
"""

from __future__ import annotations

import ctypes

import torch

from pathtracerpython_tpu_torch.kernels import build
from pathtracerpython_tpu_torch.kernels.intersect import (
    OCCLUDER_COL,
    T_MIN,
    CullBoxes,
    check_input,
    chunk_rows,
    cull_pairs,
    cull_pointers,
    mt_rows,
    scene_cull_boxes,
    scene_tripack,
)

# The kernel keeps the light table in shared memory and the samples in
# registers; scenes beyond these bounds need the unfused NEE.
FUSED_NEE_MAX_LIGHT_TRIS = 64
MAX_LIGHT_SAMPLES = 8

# Launches of the CUDA kernel since the count was last reset.
LAUNCHES = 0

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # point3, normal3, u
    ctypes.c_int, ctypes.c_int,                         # n, s_samples
    ctypes.c_void_p, ctypes.c_int,                      # tripack, t_count
    ctypes.c_void_p, ctypes.c_int,                      # lightpack, l_count
    ctypes.c_void_p, ctypes.c_void_p,                   # tile, group boxes
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # mc_out, occ_out, stats
    ctypes.c_int, ctypes.c_void_p,                      # device, stream
]


def light_pack(scene) -> torch.Tensor:
    """[L, 12]: v0.xyz | v1.xyz | v2.xyz | cumulative area | 0 | 0."""
    cum = torch.cumsum(scene.light_area, dim=0)
    zeros = torch.zeros((scene.light_v0.shape[0], 2),
                        dtype=scene.light_v0.dtype, device=cum.device)
    return torch.cat(
        [scene.light_v0, scene.light_v1, scene.light_v2, cum[:, None], zeros],
        dim=1,
    ).contiguous()


def nee_mean_cos_plain(point3, normal3, u, tripack, lightpack,
                       s_samples: int, cull: CullBoxes | None = None,
                       tested: list | None = None):
    """(mean_cos [1, N], occ [S, N]) in plain PyTorch. Without ``cull``
    every sample meets every occluder: the oracle. With ``cull`` (the
    pack's boxes) a pair counts only where the culled kernel tests it, and
    ``tested`` gets each chunk's number of such pairs."""
    n = point3.shape[1]
    n_light = lightpack.shape[0]
    total = lightpack[n_light - 1, 9]
    px, py, pz = (point3[k:k + 1] for k in range(3))
    nx, ny, nz = (normal3[k:k + 1] for k in range(3))
    # the occlusion sweep only ever keeps occluder rows (valid included)
    occluder = tripack[:, OCCLUDER_COL] > 0.5
    occluders = tripack[occluder] if cull is None else tripack
    step = chunk_rows(n)
    acc = None
    occ = []
    for s in range(s_samples):
        x = u[5 * s:5 * s + 1] * total
        pick = torch.zeros_like(x, dtype=torch.int64)
        for l in range(n_light - 1):
            pick = pick + (x >= lightpack[l, 9]).to(torch.int64)
        v = [lightpack[:, c][pick] for c in range(9)]
        su = torch.sqrt(u[5 * s + 1:5 * s + 2])
        u2 = u[5 * s + 2:5 * s + 3]
        b0 = 1.0 - su
        b1 = su * (1.0 - u2)
        b2 = su * u2
        vx = (b0 * v[0] + b1 * v[3] + b2 * v[6]) - px
        vy = (b0 * v[1] + b1 * v[4] + b2 * v[7]) - py
        vz = (b0 * v[2] + b1 * v[5] + b2 * v[8]) - pz
        sq = vx * vx + vy * vy + vz * vz
        dist = torch.sqrt(sq + 1e-24)
        inv = torch.rsqrt(torch.clamp_min(sq, 1e-30))
        sx, sy, sz = vx * inv, vy * inv, vz * inv
        cos = torch.clamp_min(sx * nx + sy * ny + sz * nz, 0.0)

        blocked = torch.zeros_like(x, dtype=torch.bool)
        for lo in range(0, occluders.shape[0], step):
            hit, t = mt_rows(occluders[lo:lo + step], px, py, pz, sx, sy, sz)
            blocking = hit & (t < dist - T_MIN)
            if cull is not None:
                keep = (cull_pairs(cull, lo, lo + hit.shape[0], (px, py, pz),
                                   (sx, sy, sz), dist)
                        & occluder[lo:lo + step, None])
                blocking = blocking & keep
                if tested is not None:
                    tested.append(int(keep.sum()))
            blocked = blocked | blocking.any(dim=0, keepdim=True)
        term = torch.where(blocked, 0.0, cos)
        acc = term if acc is None else acc + term
        occ.append(blocked.to(point3.dtype))
    return acc / float(s_samples), torch.cat(occ, dim=0)


def nee_mean_cos_fused(point3: torch.Tensor, normal3: torch.Tensor,
                       u: torch.Tensor, scene, s_samples: int):
    """Fused fast-mode NEE at shading points point3 f32[3, N] with shading
    normals normal3 f32[3, N], from uniforms u f32[5*S, N] (rows 5s+0..2
    per sample). Returns (mean_cos [1, N], occ [S, N])."""
    device = point3.device
    n = point3.shape[1] if point3.dim() == 2 else -1
    if not 1 <= s_samples <= MAX_LIGHT_SAMPLES:
        raise ValueError(
            f"s_samples={s_samples}: the fused NEE takes 1..{MAX_LIGHT_SAMPLES}"
        )
    n_light = scene.light_area.shape[0]
    if not 1 <= n_light <= FUSED_NEE_MAX_LIGHT_TRIS:
        raise ValueError(
            f"{n_light} light triangles: the fused NEE takes "
            f"1..{FUSED_NEE_MAX_LIGHT_TRIS}"
        )
    check_input("point3", point3, device, torch.float32, (3, None))
    check_input("normal3", normal3, device, torch.float32, (3, n))
    check_input("u", u, device, torch.float32, (5 * s_samples, n))
    tripack = scene_tripack(scene)
    lightpack = light_pack(scene)
    check_input("scene triangles", tripack, device, torch.float32, (None, 12))
    check_input("scene lights", lightpack, device, torch.float32, (n_light, 12))
    if device.type == "cpu":
        return nee_mean_cos_plain(point3, normal3, u, tripack, lightpack,
                                  s_samples)
    if device.type != "cuda":
        raise ValueError(f"no NEE kernel for device {device}")
    return _launch(point3, normal3, u, tripack, lightpack, s_samples,
                   scene_cull_boxes(scene))


def _launch(point3, normal3, u, tripack, lightpack, s_samples, cull,
            stats=None):
    global LAUNCHES
    n = point3.shape[1]
    mc = torch.empty((1, n), dtype=torch.float32, device=point3.device)
    occ = torch.empty((s_samples, n), dtype=torch.float32,
                      device=point3.device)
    if n == 0:
        return mc, occ
    fn = build.function("ptt_nee_mean_cos", _ARGTYPES)
    stream = torch.cuda.current_stream(point3.device).cuda_stream
    tile, group, counters = cull_pointers(cull, stats)
    err = fn(point3.data_ptr(), normal3.data_ptr(), u.data_ptr(), n,
             s_samples, tripack.data_ptr(), tripack.shape[0],
             lightpack.data_ptr(), lightpack.shape[0], tile, group,
             mc.data_ptr(), occ.data_ptr(), counters, point3.device.index,
             stream)
    if err != 0:
        raise RuntimeError(f"NEE kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return mc, occ
