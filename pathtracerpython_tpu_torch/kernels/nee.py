"""K2: the fused fast-mode NEE — CUDA kernel wrapper and plain version.

``nee_mean_cos_fused`` has the signature of the JAX package's
``kernels/nee_pallas.py:nee_mean_cos_fused`` and returns the mean
unoccluded cosine [1, N] together with the occlusion bits [S, N] (0/1
float). On a CUDA tensor it launches ``csrc/nee.cu`` (or raises); on a CPU
tensor it runs ``nee_mean_cos_plain``, which follows ``_nee_body``
operation by operation: compare-and-count light pick on the cumulative
areas, sqrt-trick barycentrics from uniform rows 5s+1 and 5s+2, direction
by rsqrt(max(sq, 1e-30)) and distance by sqrt(sq + 1e-24), clamped
cosine, occluder sweep with t < dist - 1e-4, then the mean. Where the
shading points, the normals or the light's vertices require grad it runs
under ``NeeMeanCos``, the JAX package's custom VJP: the kernel on detached
inputs, keeping ``occ``; the backward recomputes the smooth part of the
estimate in PyTorch (``smooth_mean_cos``) with the occlusion fixed.
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
    requires_grad,
    scene_cull_boxes,
    scene_tripack,
    scene_vertices,
)
from pathtracerpython_tpu_torch.ops.gather import scatter_rows

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


def light_pick(light_area, u, s_samples: int) -> torch.Tensor:
    """The light triangle of each sample, int64 [S, N]: the kernel's
    compare-and-count pick on the cumulative areas from rows 5s of the
    uniforms ``u`` [5S, N]."""
    u0 = u.reshape(s_samples, 5, -1)[:, 0]
    cum = torch.cumsum(light_area, dim=0)
    x = u0 * cum[-1]
    idx = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    for l in range(light_area.shape[0] - 1):
        idx = idx + (x >= cum[l]).to(torch.int64)
    return idx


def smooth_mean_cos(point3, normal3, lv, u, occ, s_samples: int):
    """The differentiable part of the estimate (``_smooth_mean_cos``): the
    mean clamped cosine [1, N] of the light samples with the occlusion
    ``occ`` [S, N] fixed, in the kernel's formulas; ``lv`` [S, N, 9] are
    the vertices of each sample's light triangle (``light_pick``). The
    pick and the barycentrics are functions of ``u`` alone, so they carry
    no gradient."""
    n = point3.shape[1]
    u = u.reshape(s_samples, 5, n)
    lv = lv.permute(2, 0, 1)                               # [9, S, N]
    su = torch.sqrt(u[:, 1])
    b0, b1, b2 = 1.0 - su, su * (1.0 - u[:, 2]), su * u[:, 2]
    lp = b0[None] * lv[0:3] + b1[None] * lv[3:6] + b2[None] * lv[6:9]
    vec = lp - point3[:, None, :]
    inv = torch.rsqrt(torch.clamp_min((vec * vec).sum(dim=0), 1e-30))
    # torch.maximum splits the gradient of a tie as jnp.maximum does (a
    # light sample in the shading point's own plane has cos exactly 0)
    cos = (vec * inv[None] * normal3[:, None, :]).sum(dim=0)
    cos = torch.maximum(cos, cos.new_zeros(()))
    masked = torch.where(occ > 0.5, 0.0, cos)
    return masked.sum(dim=0)[None, :] / float(s_samples)


class NeeMeanCos(torch.autograd.Function):
    """(mean_cos [1, N], occ [S, N]) of the fused NEE with the JAX
    package's custom VJP (``_nee_vjp_fwd`` / ``_nee_vjp_bwd``):
    ``forward(point3, normal3, lv0, lv1, lv2, light_area, u, s_samples,
    sweep)`` runs ``sweep(point3, normal3, u)``, K2 or its plain version, on
    detached inputs and keeps ``occ``; ``backward`` recomputes
    ``smooth_mean_cos`` with ``occ`` fixed and returns the gradients of
    point3, normal3 and the light's vertices, the last summed per light
    triangle by ``ops.gather.scatter_rows``. ``light_area``, ``u`` and the
    occluders get none: the draws and the occlusion are detached by
    design."""

    @staticmethod
    def forward(ctx, point3, normal3, lv0, lv1, lv2, light_area, u,
                s_samples, sweep):
        mc, occ = sweep(point3.detach(), normal3.detach(), u.detach())
        ctx.save_for_backward(point3, normal3, lv0, lv1, lv2, light_area, u,
                              occ)
        ctx.s_samples = s_samples
        ctx.mark_non_differentiable(occ)
        return mc, occ

    @staticmethod
    def backward(ctx, g, _gocc):
        point3, normal3, lv0, lv1, lv2, light_area, u, occ = ctx.saved_tensors
        s = ctx.s_samples
        needs = ctx.needs_input_grad
        pick = light_pick(light_area.detach(), u.detach(), s)
        table = torch.cat([lv0, lv1, lv2], dim=1).detach()    # [L, 9]
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(need) for x, need in zip(
                (point3, normal3, table[pick]),
                (needs[0], needs[1], any(needs[2:5])))]
            mc = smooth_mean_cos(*leaves, u.detach(), occ, s)
            wanted = [x for x in leaves if x.requires_grad]
            grads = iter(torch.autograd.grad(mc, wanted, g) if wanted
                         else ())
        d_p, d_n, d_lv = (next(grads) if x.requires_grad else None
                          for x in leaves)
        d_lights = (None, None, None)
        if d_lv is not None:
            d_table = scatter_rows(d_lv.reshape(-1, 9), pick.reshape(-1),
                                   table.shape[0])
            d_lights = tuple(d_table[:, 3 * k:3 * k + 3] if need else None
                             for k, need in enumerate(needs[2:5]))
        return d_p, d_n, *d_lights, None, None, None, None


def nee_mean_cos_fused(point3: torch.Tensor, normal3: torch.Tensor,
                       u: torch.Tensor, scene, s_samples: int):
    """Fused fast-mode NEE at shading points point3 f32[3, N] with shading
    normals normal3 f32[3, N], from uniforms u f32[5*S, N] (rows 5s+0..2
    per sample). Returns (mean_cos [1, N], occ [S, N]); mean_cos is
    differentiable in point3, normal3 and the scene's ``light_v0/1/2``
    (``NeeMeanCos``)."""
    lights = (scene.light_v0, scene.light_v1, scene.light_v2)
    if not requires_grad(point3, normal3, u, *lights, scene.light_area,
                         *scene_vertices(scene)):
        return _nee_mean_cos(point3, normal3, u, scene, s_samples)
    plain = scene.detach()
    return NeeMeanCos.apply(
        point3, normal3, *lights, scene.light_area, u, s_samples,
        lambda p, n, uu: _nee_mean_cos(p, n, uu, plain, s_samples))


def _nee_mean_cos(point3, normal3, u, scene, s_samples):
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
