"""P2: does the Möller–Trumbore pair test run faster in bf16?

The counterpart of the JAX package's ``scripts/bf16_probe.py``. One tile of
triangles against a wavefront of rays, the classic test's operations in
float32 and in bf16 (operands cast at load, every product, sum and
difference rounded to bf16, the reciprocal taken in float32 and rounded,
comparisons in float32); the output is the number of triangles each ray
hits (``csrc/probe_bf16.cu``). It prints one JSON line per variant (ms,
G pairs/s, and for bf16 how its counts differ from float32's) and the ratio
bf16 / f32. A bf16 pre-test ahead of the float32 sweeps can only pay if
that ratio is near 2.

    python -m pathtracerpython_tpu_torch.probes.bf16_probe [n_rays_log2] \\
        [--tris 512] [--reps 8] [--device cpu]

Runs on the card; without one it raises, unless ``--device cpu`` asks for
the plain versions (which are timed by the host clock and say so).
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from pathtracerpython_tpu_torch.kernels import build
from pathtracerpython_tpu_torch.kernels.intersect import (
    DET_EPS,
    T_MIN,
    check_input,
    chunk_rows,
)
from pathtracerpython_tpu_torch.probes.mma_probe import (
    resolve_device,
    time_ms,
)

VARIANTS = ("f32", "bf16")
_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}

# Launches of the CUDA kernel since the counts were last reset, by variant.
LAUNCHES = dict.fromkeys(VARIANTS, 0)

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # o3, d3, n
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,      # tripack, T, variant
    ctypes.c_void_p,                                  # count_out
    ctypes.c_int, ctypes.c_void_p,                    # device, stream
]


def make_inputs(n_rays: int, n_tris: int = 512, seed: int = 0, device="cpu"):
    """(o3 f32[3, N], d3 f32[3, N], tripack f32[T, 12]) as the JAX probe
    draws them: vertices and origins uniform in [-2, 2], directions normal
    (not normalized); every row valid."""
    rng = np.random.default_rng(seed)
    tripack = rng.uniform(-2, 2, (n_tris, 12)).astype(np.float32)
    tripack[:, 9:11] = 1.0
    tripack[:, 11] = 0.0
    o3 = rng.uniform(-2, 2, (3, n_rays)).astype(np.float32)
    d3 = rng.normal(size=(3, n_rays)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (o3, d3, tripack))


def hit_count_plain(o3, d3, tripack, variant: str) -> torch.Tensor:
    """The variant's plain version: f32[N], the triangles each ray hits,
    with ``mt_rows``' operations carried out in the variant's type."""
    dtype = _DTYPES[variant]
    n = o3.shape[1]
    ox, oy, oz = (o3[k:k + 1].to(dtype) for k in range(3))
    dx, dy, dz = (d3[k:k + 1].to(dtype) for k in range(3))
    count = torch.zeros(n, dtype=torch.float32, device=o3.device)
    step = chunk_rows(n)
    for lo in range(0, tripack.shape[0], step):
        tri = tripack[lo:lo + step]
        col = lambda c: tri[:, c:c + 1].to(dtype)
        v0x, v0y, v0z = col(0), col(1), col(2)
        e1x, e1y, e1z = col(3) - v0x, col(4) - v0y, col(5) - v0z
        e2x, e2y, e2z = col(6) - v0x, col(7) - v0y, col(8) - v0z
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        not_par = det.float().abs() > DET_EPS
        inv_det = (1.0 / torch.where(not_par, det.float(), 1.0)).to(dtype)
        tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
        uf, vf, tf = u.float(), v.float(), t.float()
        hit = (not_par & (uf >= 0.0) & (vf >= 0.0) & (uf + vf <= 1.0)
               & (tf > T_MIN) & (tri[:, 9:10] > 0.5))
        count += hit.sum(dim=0, dtype=torch.float32)
    return count


def hit_count(o3, d3, tripack, variant: str) -> torch.Tensor:
    """The variant's sweep: its CUDA kernel on CUDA tensors (or raises), its
    plain version on CPU tensors."""
    if variant not in VARIANTS:
        raise ValueError(f"variant={variant!r}: expected one of {VARIANTS}")
    device = o3.device
    n = o3.shape[1] if o3.dim() == 2 else -1
    check_input("o3", o3, device, torch.float32, (3, None))
    check_input("d3", d3, device, torch.float32, (3, n))
    check_input("tripack", tripack, device, torch.float32, (None, 12))
    if device.type == "cpu":
        return hit_count_plain(o3, d3, tripack, variant)
    if device.type != "cuda":
        raise ValueError(f"no probe kernel for device {device}")
    count = torch.empty(n, dtype=torch.float32, device=device)
    fn = build.function("ptt_probe_bf16", _ARGTYPES)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(o3.data_ptr(), d3.data_ptr(), n, tripack.data_ptr(),
             tripack.shape[0], VARIANTS.index(variant), count.data_ptr(),
             device.index, stream)
    if err != 0:
        raise RuntimeError(
            f"ptt_probe_bf16 ({variant}): kernel launch failed: CUDA error "
            f"{err}")
    LAUNCHES[variant] += 1
    return count


def run(n_rays: int = 1 << 20, n_tris: int = 512, reps: int = 8,
        device: str | None = None, seed: int = 0) -> list[dict]:
    """Run both variants on the same inputs; returns one row per variant
    and the verdict's row last."""
    dev = resolve_device(device)
    o3, d3, tripack = make_inputs(n_rays, n_tris, seed, dev)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu (plain versions, host clock)")
    rows, counts = [], {}
    for variant in VARIANTS:
        sweep = lambda: hit_count(o3, d3, tripack, variant)
        counts[variant] = sweep()
        ms = time_ms(sweep, reps, dev)
        rows.append({"what": "bf16_probe", "impl": variant, "device": where,
                     "rays": n_rays, "tris": n_tris, "ms": ms,
                     "gpairs_per_s": n_rays * n_tris / (ms * 1e-3) / 1e9,
                     "hits_per_ray": counts[variant].mean().item()})
    diff = (counts["bf16"] - counts["f32"]).abs()
    rows.append({"what": "bf16_probe_verdict",
                 "bf16_over_f32": rows[1]["gpairs_per_s"]
                 / rows[0]["gpairs_per_s"],
                 "rays_with_other_count": (diff > 0).float().mean().item(),
                 "max_count_diff": diff.max().item()})
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_rays_log2", type=int, nargs="?", default=20)
    p.add_argument("--tris", type=int, default=512)
    p.add_argument("--reps", type=int, default=8)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    for row in run(1 << args.n_rays_log2, args.tris, args.reps, args.device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
