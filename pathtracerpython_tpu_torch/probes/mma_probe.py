"""P1: can the ray-triangle sweep ride the card's tensor cores?

The counterpart of the JAX package's ``scripts/mxu_probe.py``. One tile of
triangles against a wavefront of rays, per-ray (t, index) of the nearest
hit (t = 3e38 and index = 2^31 - 1 on a miss), in four variants
(``csrc/probe_plucker.cu``):

- ``mt``: classic Möller–Trumbore on the CUDA cores;
- ``plucker_fma``: the Plücker form with its side products as float32
  multiplies and adds on the CUDA cores, K3's production form;
- ``plucker_tf32``: the side products as one pass of TF32
  ``mma.sync.m16n8k8`` on the tensor cores;
- ``plucker_3xtf32``: the same with every operand split into two TF32
  values and three passes.

It prints one JSON line per variant (ms, G tests/s, the share of rays whose
winner differs from ``mt``'s, the largest float64 barycentric margin among
those, the largest t difference on equal winners) and their ratios to
``mt``. It asserts the JAX probe's gate (winners differ on < 0.2% of rays,
t within 1e-3) for ``plucker_fma`` and ``plucker_3xtf32``; the one-pass
TF32 figure is reported and not asserted: it is the finding.

    python -m pathtracerpython_tpu_torch.probes.mma_probe \\
        [--rays 262144] [--tris 512] [--reps 20] [--device cpu]

Runs on the card; without one it raises, unless ``--device cpu`` asks for
the plain versions (which are timed by the host clock and say so).
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import time

import numpy as np
import torch

from pathtracerpython_tpu_torch.kernels import build
from pathtracerpython_tpu_torch.kernels.intersect import (
    BIG,
    CLASSIC,
    IMAX,
    PLUCKER,
    PairTest,
    check_input,
    nearest_t_idx_plain,
    plucker_inside,
    plucker_pack,
    plucker_plane,
)

VARIANTS = ("mt", "plucker_fma", "plucker_tf32", "plucker_3xtf32")
ASSERTED = ("plucker_fma", "plucker_3xtf32")
MAX_WINNER_DIFF = 2e-3  # the JAX probe's gate
MAX_T_ERR = 1e-3

# Launches of the CUDA kernel since the counts were last reset, by variant.
LAUNCHES = dict.fromkeys(VARIANTS, 0)

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # o3, d3, n
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,   # tripack, pack36, T
    ctypes.c_int,                                     # variant
    ctypes.c_void_p, ctypes.c_void_p,                 # t_out, idx_out
    ctypes.c_int, ctypes.c_void_p,                    # device, stream
]


def make_inputs(n_rays: int, n_tris: int, seed: int = 0, device="cpu"):
    """(o3 f32[3, N], d3 f32[3, N] unit, tripack f32[T, 12]) drawn as the
    JAX probe draws them: v0 uniform in [-4, 4]^3, edges uniform in
    [-1, 1]^3, origins uniform in [-5, 5]^3, directions normal."""
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-4, 4, (n_tris, 3)).astype(np.float32)
    v1 = v0 + rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    v2 = v0 + rng.uniform(-1, 1, (n_tris, 3)).astype(np.float32)
    o = rng.uniform(-5, 5, (n_rays, 3)).astype(np.float32)
    d = rng.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ones = np.ones((n_tris, 1), np.float32)
    tripack = np.concatenate([v0, v1, v2, ones, ones, 0 * ones], axis=1)
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return to(o.T), to(d.T), to(tripack)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero: ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def plucker_rows_tf32(pack, ox, oy, oz, dx, dy, dz, split: bool):
    """``plucker_rows`` with the side products' operands rounded to TF32
    (``split``: each operand as hi + lo, the products hi.lo + lo.hi +
    hi.hi), summed in float32; the plane's t stays float32."""
    mx = oy * dz - oz * dy
    my = oz * dx - ox * dz
    mz = ox * dy - oy * dx
    ray = [mx, my, mz, dx, dy, dz]
    ray_hi = [tf32(r) for r in ray]
    ray_lo = [tf32(r - h) for r, h in zip(ray, ray_hi)]
    col = lambda c: pack[..., c:c + 1]

    def side(c):
        cols = [col(c + k) for k in range(6)]
        hi = [tf32(x) for x in cols]
        total = 0.0
        if split:
            lo = [tf32(x - h) for x, h in zip(cols, hi)]
            for a, b in zip(hi, ray_lo):
                total = total + a * b
            for a, b in zip(lo, ray_hi):
                total = total + a * b
        for a, b in zip(hi, ray_hi):
            total = total + a * b
        return total

    plane, t = plucker_plane(pack, ox, oy, oz, dx, dy, dz)
    return plucker_inside(side(0), side(8), side(16)) & plane, t


_PAIRS = {
    "mt": CLASSIC,
    "plucker_fma": PLUCKER,
    "plucker_tf32": PairTest(
        functools.partial(plucker_rows_tf32, split=False), 31, 30),
    "plucker_3xtf32": PairTest(
        functools.partial(plucker_rows_tf32, split=True), 31, 30),
}


def probe_plain(o3, d3, tripack, variant: str):
    """The variant's plain version: (t [N] — 3e38 on a miss, idx [N] int32
    — 2^31 - 1 on a miss)."""
    pack = tripack if variant == "mt" else plucker_pack(tripack)
    t, idx = nearest_t_idx_plain(o3, d3, pack, _PAIRS[variant])
    miss = idx < 0
    return torch.where(miss, BIG, t), torch.where(miss, IMAX, idx)


def probe(o3, d3, tripack, variant: str, pack36=None):
    """The variant's sweep: its CUDA kernel on CUDA tensors (or raises), its
    plain version on CPU tensors. ``pack36``: ``plucker_pack(tripack)`` if
    the caller has it already."""
    if variant not in VARIANTS:
        raise ValueError(f"variant={variant!r}: expected one of {VARIANTS}")
    device = o3.device
    n = o3.shape[1] if o3.dim() == 2 else -1
    check_input("o3", o3, device, torch.float32, (3, None))
    check_input("d3", d3, device, torch.float32, (3, n))
    check_input("tripack", tripack, device, torch.float32, (None, 12))
    if device.type == "cpu":
        return probe_plain(o3, d3, tripack, variant)
    if device.type != "cuda":
        raise ValueError(f"no probe kernel for device {device}")
    if pack36 is None:
        pack36 = plucker_pack(tripack)
    check_input("pack36", pack36, device, torch.float32,
                (tripack.shape[0], 36))
    t = torch.empty(n, dtype=torch.float32, device=device)
    idx = torch.empty(n, dtype=torch.int32, device=device)
    fn = build.function("ptt_probe_plucker", _ARGTYPES)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(o3.data_ptr(), d3.data_ptr(), n, tripack.data_ptr(),
             pack36.data_ptr(), tripack.shape[0], VARIANTS.index(variant),
             t.data_ptr(), idx.data_ptr(), device.index, stream)
    if err != 0:
        raise RuntimeError(
            f"ptt_probe_plucker ({variant}): kernel launch failed: CUDA "
            f"error {err}")
    LAUNCHES[variant] += 1
    return t, idx


def bary_margin_f64(tripack, o3, d3, idx) -> torch.Tensor:
    """|min(u, v, 1-u-v)| in float64 of ray i against triangle idx[i]: how
    far from an edge the hit lies; inf where idx names no triangle."""
    ok = (idx >= 0) & (idx < tripack.shape[0])
    row = tripack[idx.clamp(0, tripack.shape[0] - 1).long()].double()
    v0, e1, e2 = row[:, 0:3], row[:, 3:6] - row[:, 0:3], row[:, 6:9] - row[:, 0:3]
    o, d = o3.T.double(), d3.T.double()
    pv = torch.linalg.cross(d, e2)
    det = (e1 * pv).sum(dim=1)
    det = torch.where(det.abs() < 1e-300, 1e-300, det)
    tv = o - v0
    u = (tv * pv).sum(dim=1) / det
    v = (d * torch.linalg.cross(tv, e1)).sum(dim=1) / det
    margin = torch.minimum(torch.minimum(u, v), 1.0 - u - v).abs()
    return torch.where(ok, margin, float("inf"))


def compare(tripack, o3, d3, got, want) -> dict:
    """How (t, idx) ``got`` differs from ``want``: the share of rays with
    another winner, the largest float64 barycentric margin among those
    (the smaller of the two winners' margins per ray), and the largest t
    difference on rays with the same winner that hit."""
    (t_g, i_g), (t_w, i_w) = got, want
    differ = i_g != i_w
    margin = 0.0
    if bool(differ.any()):
        o_b, d_b = o3[:, differ], d3[:, differ]
        margin = torch.minimum(
            bary_margin_f64(tripack, o_b, d_b, i_g[differ]),
            bary_margin_f64(tripack, o_b, d_b, i_w[differ])).max().item()
    both = ~differ & (i_w != IMAX)
    t_err = (t_g[both] - t_w[both]).abs().max().item() if bool(
        both.any()) else 0.0
    return {"winner_diff_share": differ.float().mean().item(),
            "winner_diff_rays": int(differ.sum()),
            "max_margin_f64": margin, "max_t_err": t_err}


def time_ms(fn, reps: int, device: torch.device) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up
    run: CUDA events on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def resolve_device(name: str | None) -> torch.device:
    """The card, unless ``name`` asks for another device; no card and no
    ``--device cpu`` raises."""
    if name is not None:
        return torch.device(name)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the probe runs on the card (pass --device cpu "
            "for the plain versions)")
    return torch.device("cuda", torch.cuda.current_device())


def run(n_rays: int = 262144, n_tris: int = 512, reps: int = 20,
        device: str | None = None, seed: int = 0) -> list[dict]:
    """Run every variant on the same inputs; returns one row per variant
    and the ratios' row last, and raises if an asserted variant misses the
    gate."""
    dev = resolve_device(device)
    o3, d3, tripack = make_inputs(n_rays, n_tris, seed, dev)
    pack36 = plucker_pack(tripack)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu (plain versions, host clock)")
    rows, want = [], None
    for variant in VARIANTS:
        sweep = lambda: probe(o3, d3, tripack, variant, pack36)
        got = sweep()
        want = got if want is None else want
        ms = time_ms(sweep, reps, dev)
        row = {"what": "mma_probe", "kernel": variant, "device": where,
               "rays": n_rays, "tris": n_tris, "ms": ms,
               "gtest_per_s": n_rays * n_tris / (ms * 1e-3) / 1e9,
               **compare(tripack, o3, d3, got, want)}
        rows.append(row)
        if variant in ASSERTED:
            if row["winner_diff_share"] >= MAX_WINNER_DIFF:
                raise AssertionError(
                    f"{variant}: winners differ from mt's on "
                    f"{row['winner_diff_share']:.4%} of rays")
            if row["max_t_err"] >= MAX_T_ERR:
                raise AssertionError(
                    f"{variant}: t differs from mt's by {row['max_t_err']}")
    rows.append({"what": "mma_probe_verdict", **{
        f"{r['kernel']}_vs_mt": r["gtest_per_s"] / rows[0]["gtest_per_s"]
        for r in rows[1:]}})
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rays", type=int, default=262144)
    p.add_argument("--tris", type=int, default=512)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    for row in run(args.rays, args.tris, args.reps, args.device):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
