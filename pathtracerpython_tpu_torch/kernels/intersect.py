"""K1 and K4: the dense nearest-hit and any-hit sweeps — CUDA kernel
wrappers and plain versions.

``nearest_t_idx_cm`` (K1) has the signature of the JAX package's
``kernels/intersect_pallas.py:nearest_t_idx_cm``, ``any_hit_cm`` (K4) that of
its ``any_hit_pallas_cm``. On a CUDA tensor each launches its kernel
(``csrc/nearest.cu``, ``csrc/any_hit.cu``) or raises; on a CPU tensor it runs
its plain version, the same arithmetic in PyTorch: Möller–Trumbore in
``_mt_rows``' component order, then the per-ray (t, index) minimum with the
smallest index winning ties (K1), or any occluder hit with
t < maxd - 1e-4 (K4). Forward only: inputs that require grad are refused,
since a silent zero gradient would be a fault.
"""

from __future__ import annotations

import ctypes

import torch

from pathtracerpython_tpu_torch.kernels import build

DET_EPS = 1e-7  # |det| > DET_EPS: not parallel
T_MIN = 1e-4    # forward near-clip, t > T_MIN
BIG = 3.0e38    # "no hit yet"
IMAX = 2**31 - 1

# The plain sweeps hold [rows, N] temporaries; rows per chunk are chosen so
# one temporary stays under this many elements.
PLAIN_CHUNK_ELEMS = 1 << 24

# Launches of the CUDA kernels since the counts were last reset: K1, K4.
LAUNCHES = 0
ANY_HIT_LAUNCHES = 0

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # o3, d3, n
    ctypes.c_void_p, ctypes.c_int,                    # tripack, t_count
    ctypes.c_void_p, ctypes.c_void_p,                 # t_out, idx_out
    ctypes.c_int, ctypes.c_void_p,                    # device, stream
]
_ANY_HIT_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # o3, d3, maxd
    ctypes.c_int,                                       # n
    ctypes.c_void_p, ctypes.c_int,                      # tripack, t_count
    ctypes.c_void_p,                                    # occ_out
    ctypes.c_int, ctypes.c_void_p,                      # device, stream
]


def scene_tripack(scene) -> torch.Tensor:
    """f32[T, 12] triangle pack: v0.xyz | v1.xyz | v2.xyz | valid |
    occluder | 0, the layout both kernels read."""
    v0 = scene.tri_v0
    flag = lambda m: m.to(v0.dtype)[:, None]
    return torch.cat(
        [v0, scene.tri_v1, scene.tri_v2, flag(scene.tri_valid),
         flag(scene.tri_occluder), torch.zeros_like(v0[:, :1])],
        dim=1,
    ).contiguous()


def mt_rows(tri: torch.Tensor, ox, oy, oz, dx, dy, dz):
    """Möller–Trumbore of [..., T, 12] pack rows against [..., 1, R] ray
    rows -> (hit [..., T, R] incl. the valid column, t [..., T, R]); the
    operation order of ``intersect_pallas.py:_mt_rows``."""
    col = lambda c: tri[..., c:c + 1]
    v0x, v0y, v0z = col(0), col(1), col(2)
    e1x, e1y, e1z = col(3) - v0x, col(4) - v0y, col(5) - v0z
    e2x, e2y, e2z = col(6) - v0x, col(7) - v0y, col(8) - v0z

    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    not_par = torch.abs(det) > DET_EPS
    inv_det = 1.0 / torch.where(not_par, det, 1.0)

    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det

    hit = (
        not_par & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN)
        & (col(9) > 0.5)
    )
    return hit, t


def chunk_rows(n_rays: int) -> int:
    """Triangle rows per plain-sweep chunk for ``n_rays`` lanes."""
    return max(1, PLAIN_CHUNK_ELEMS // max(n_rays, 1))


def nearest_t_idx_plain(o3: torch.Tensor, d3_unit: torch.Tensor,
                        tripack: torch.Tensor):
    """(t [N] — 0 on a miss, idx [N] int32 — -1 on a miss)."""
    n = o3.shape[1]
    rays = [o3[k:k + 1] for k in range(3)] + [d3_unit[k:k + 1] for k in range(3)]
    best_t = torch.full((1, n), BIG, dtype=o3.dtype, device=o3.device)
    best_idx = torch.full((1, n), -1, dtype=torch.int32, device=o3.device)
    step = chunk_rows(n)
    for lo in range(0, tripack.shape[0], step):
        hit, t = mt_rows(tripack[lo:lo + step], *rays)
        # the tile merge of intersect_pallas.py:_merge_nearest_tile: the
        # chunk minimum, the smallest index attaining it, then a strict <
        key = torch.where(hit, t, BIG)
        chunk_min = key.min(dim=0, keepdim=True).values
        gidx = torch.arange(lo, lo + key.shape[0], dtype=torch.int32,
                            device=o3.device)[:, None]
        cand = torch.where((key == chunk_min) & hit, gidx, IMAX)
        chunk_idx = cand.min(dim=0, keepdim=True).values
        better = (chunk_min < best_t) & (chunk_idx != IMAX)
        best_t = torch.where(better, chunk_min, best_t)
        best_idx = torch.where(better, chunk_idx, best_idx)
    idx = best_idx[0]
    return torch.where(idx >= 0, best_t[0], 0.0), idx


def check_input(name: str, x: torch.Tensor, device: torch.device,
                dtype: torch.dtype, shape: tuple) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape``
    (None matches any extent) on ``device`` that does not require grad."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if x.dim() != len(shape) or any(
        want is not None and got != want for got, want in zip(x.shape, shape)
    ):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.requires_grad:
        raise RuntimeError(
            f"{name} requires grad: the kernels are forward only (the "
            "autograd backward comes with the gradient slice)"
        )


def nearest_t_idx_cm(o3: torch.Tensor, d3_unit: torch.Tensor, scene):
    """Closest forward hit of rays o3/d3_unit f32[3, N] (d3_unit of unit
    length) against the scene's triangles. Returns (t [N] — 0 on a miss,
    idx [N] int32 — -1 on a miss)."""
    device = o3.device
    n = o3.shape[1] if o3.dim() == 2 else -1
    check_input("o3", o3, device, torch.float32, (3, None))
    check_input("d3_unit", d3_unit, device, torch.float32, (3, n))
    tripack = scene_tripack(scene)
    check_input("scene triangles", tripack, device, torch.float32, (None, 12))
    if device.type == "cpu":
        return nearest_t_idx_plain(o3, d3_unit, tripack)
    if device.type != "cuda":
        raise ValueError(f"no nearest-hit kernel for device {device}")
    return _launch(o3, d3_unit, tripack)


def _launch(o3, d3_unit, tripack):
    global LAUNCHES
    n = o3.shape[1]
    t = torch.empty(n, dtype=torch.float32, device=o3.device)
    idx = torch.empty(n, dtype=torch.int32, device=o3.device)
    if n == 0:
        return t, idx
    fn = build.function("ptt_nearest_t_idx", _ARGTYPES)
    stream = torch.cuda.current_stream(o3.device).cuda_stream
    err = fn(o3.data_ptr(), d3_unit.data_ptr(), n, tripack.data_ptr(),
             tripack.shape[0], t.data_ptr(), idx.data_ptr(),
             o3.device.index, stream)
    if err != 0:
        raise RuntimeError(f"nearest-hit kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return t, idx


def any_hit_plain(o3: torch.Tensor, d3_unit: torch.Tensor,
                  maxd: torch.Tensor, tripack: torch.Tensor) -> torch.Tensor:
    """Occlusion bool[N] of rays o3/d3_unit within maxd, chunked over the
    occluder rows."""
    rays = [o3[k:k + 1] for k in range(3)] + [d3_unit[k:k + 1] for k in range(3)]
    occluders = tripack[tripack[:, 10] > 0.5]
    limit = maxd[None, :] - T_MIN
    blocked = torch.zeros_like(limit, dtype=torch.bool)
    step = chunk_rows(o3.shape[1])
    for lo in range(0, occluders.shape[0], step):
        hit, t = mt_rows(occluders[lo:lo + step], *rays)
        blocked = blocked | (hit & (t < limit)).any(dim=0, keepdim=True)
    return blocked[0]


def any_hit_cm(o3: torch.Tensor, d3_unit: torch.Tensor, maxd: torch.Tensor,
               scene) -> torch.Tensor:
    """Whether an occluder triangle of the scene blocks each shadow ray
    o3/d3_unit f32[3, N] (d3_unit of unit length) at t < maxd - 1e-4;
    bool[N]. Lanes with maxd = 0 (parked) are never occluded."""
    device = o3.device
    n = o3.shape[1] if o3.dim() == 2 else -1
    check_input("o3", o3, device, torch.float32, (3, None))
    check_input("d3_unit", d3_unit, device, torch.float32, (3, n))
    check_input("maxd", maxd, device, torch.float32, (n,))
    tripack = scene_tripack(scene)
    check_input("scene triangles", tripack, device, torch.float32, (None, 12))
    if device.type == "cpu":
        return any_hit_plain(o3, d3_unit, maxd, tripack)
    if device.type != "cuda":
        raise ValueError(f"no any-hit kernel for device {device}")
    return _launch_any_hit(o3, d3_unit, maxd, tripack)


def _launch_any_hit(o3, d3_unit, maxd, tripack):
    global ANY_HIT_LAUNCHES
    n = o3.shape[1]
    occ = torch.empty(n, dtype=torch.bool, device=o3.device)
    if n == 0:
        return occ
    fn = build.function("ptt_any_hit", _ANY_HIT_ARGTYPES)
    stream = torch.cuda.current_stream(o3.device).cuda_stream
    err = fn(o3.data_ptr(), d3_unit.data_ptr(), maxd.data_ptr(), n,
             tripack.data_ptr(), tripack.shape[0], occ.data_ptr(),
             o3.device.index, stream)
    if err != 0:
        raise RuntimeError(f"any-hit kernel launch failed: CUDA error {err}")
    ANY_HIT_LAUNCHES += 1
    return occ
