#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile  # also profiles one render of each cell

Drives ``pathtracerpython_tpu_torch`` through its public entry points on the
card, in five phases, and fails (non-zero exit, no result line) if any
phase fails:

0. card identity: ``nvidia-smi`` name and power limit, torch and CUDA
   versions; no CUDA device is an error;
1. build: compiles ``pathtracerpython_tpu_torch/csrc/*.cu`` with nvcc;
2. kernel against plain: K1 (nearest hit) and K2 (fused NEE) against their
   plain PyTorch versions on the card, on the first and second bounce
   wavefronts of the 512x512x4spp render (1,048,576 lanes), for the Cornell
   stand-in and a 300-box field (3,604 triangles, still dense), with
   CUDA-event times of both;
3. the full render: Cornell stand-in at 512x512, 4 spp, 4 bounces, 3 NEE
   samples; radiance finite, non-negative and not constant; each kernel
   launched exactly once per bounce; and a 32x32 render on the card held
   against the same render on the CPU (the plain versions);
4. timing: ms per render (CUDA events, 2 warm-up renders, median of 10)
   and Mrays/s counted two ways, for the Cornell cell and the box field at
   512x512, 2 spp, 3 bounces.

The next-to-last line is a JSON object with one entry per kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

CORNELL_SIZE = 512
CORNELL_SPP = 4
CORNELL_BOUNCES = 4
NEE_SAMPLES = 3
FIELD_BOXES = 300
FIELD_SPP = 2
FIELD_BOUNCES = 3

# The port is read from the checkout that holds this script, never from
# another installation.
ROOT = os.path.dirname(os.path.abspath(__file__))

# Kernel against plain on the card. Both compute the same float32 ops in
# the same order (the kernels are built with -fmad=false), so they should
# agree bit for bit; the bounds leave room for boundary-grazing lanes only.
MIN_IDX_AGREE = 0.9999       # K1: share of lanes with the same winner
T_RTOL = T_ATOL = 1e-6       # K1: t on lanes with the same winner
GRAZING_MARGIN = 1e-5        # K1: float64 barycentric margin of a mismatch
MIN_OCC_AGREE = 0.9999       # K2: share of (lane, sample) occlusion bits
MC_ATOL = 1e-5               # K2: mean cosine on lanes whose bits agree
# Card against CPU at 32x32: the CPU's rsqrt, sin and cos round differently
# in the last bit; the scene keeps those ulps from flipping discrete events.
RENDER_RTOL = RENDER_ATOL = 1e-4
MIN_PIXELS_CLOSE = 0.99


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_runs(fn, warmup: int, reps: int) -> list[float]:
    """Milliseconds of each of ``reps`` runs of ``fn()`` after ``warmup``
    untimed runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        times.append(cuda_ms(fn, 1))
    return times


def phase0_identity() -> tuple[str, str]:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[0] card: {card}")
    log(f"[0] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0: {name}, devices: {torch.cuda.device_count()}")
    return card, name


def phase1_build() -> None:
    sys.path.insert(0, ROOT)
    import pathtracerpython_tpu_torch as port
    from pathtracerpython_tpu_torch.kernels import build

    if os.path.dirname(os.path.dirname(os.path.abspath(port.__file__))) != ROOT:
        fail(f"the port was imported from {port.__file__}, not from {ROOT}")

    t0 = time.perf_counter()
    path = build.build()
    secs = time.perf_counter() - t0
    log(f"[1] built {path} in {secs:.1f} s")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[1]   ptxas: {line.strip()}")


def bary_margin_f64(tripack: np.ndarray, o, d, idx: int) -> float:
    """min(u, v, 1-u-v) of ray (o, d) against pack row ``idx``, in float64:
    how far inside the triangle the hit lies."""
    row = tripack[idx].astype(np.float64)
    v0, v1, v2 = row[0:3], row[3:6], row[6:9]
    o = o.astype(np.float64)
    d = d.astype(np.float64)
    e1, e2 = v1 - v0, v2 - v0
    pv = np.cross(d, e2)
    det = np.dot(e1, pv)
    if abs(det) < 1e-300:
        return 0.0
    tv = o - v0
    u = np.dot(tv, pv) / det
    v = np.dot(d, np.cross(tv, e1)) / det
    return min(u, v, 1.0 - u - v)


def wavefronts(scene, spp: int):
    """Inputs of both kernels on the first and second bounce wavefronts of
    the scene's batch_samples render: [(o3, d3u, point3, normal3, u_nee)]."""
    from pathtracerpython_tpu_torch.ops import rng
    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
    from pathtracerpython_tpu_torch.ops.geometry import (
        nearest_hit_cm,
        normalize3,
    )
    from pathtracerpython_tpu_torch.render import integrator
    from pathtracerpython_tpu_torch.render.config import RenderConfig

    cfg = RenderConfig(n_samples=spp, n_bounces=2,
                       n_light_samples=NEE_SAMPLES, batch_samples=True)
    w, h = scene.meta.width, scene.meta.height
    origins, dirs = make_primary_rays(scene.eye, scene.ortho, w, h)
    pid = torch.arange(w * h, device=scene.device)
    counters = torch.cat([pid * spp + s for s in range(spp)])
    state = integrator.init_rays(origins.T.repeat(1, spp),
                                 dirs.T.repeat(1, spp), counters)
    k0, k1 = rng.key_from_seed(0)
    out = []
    for b in range(2):
        nk = rng.fold(k0, k1, b * 4 + integrator._P_NEE)
        u_nee = rng.uniforms(*nk, state.counters, NEE_SAMPLES * 5)
        d3u = normalize3(state.direction3)
        hit = nearest_hit_cm(state.origin3, state.direction3, scene)
        shading = integrator.arrival_side_normal(hit.normal3, d3u)
        out.append((state.origin3, d3u, hit.point3, shading, u_nee))
        state = integrator.bounce_step(state, b, scene, cfg, k0, k1)
    return out


def check_k1(label, scene, o3, d3u, report) -> None:
    from pathtracerpython_tpu_torch.kernels import intersect

    tripack = intersect.scene_tripack(scene)
    t_k, i_k = intersect.nearest_t_idx_cm(o3, d3u, scene)
    t_p, i_p = intersect.nearest_t_idx_plain(o3, d3u, tripack)
    torch.cuda.synchronize()
    same = i_k == i_p
    agree = same.float().mean().item()
    if agree < MIN_IDX_AGREE:
        fail(f"K1 {label}: winners agree on {agree:.6f} of lanes")
    bad = torch.nonzero(~same).flatten().cpu().numpy()
    if len(bad):
        pack = tripack.cpu().numpy()
        o_np, d_np = o3.cpu().numpy(), d3u.cpu().numpy()
        ik, ip = i_k.cpu().numpy(), i_p.cpu().numpy()
        for r in bad:
            margins = [abs(bary_margin_f64(pack, o_np[:, r], d_np[:, r], i))
                       for i in (ik[r], ip[r]) if i >= 0]
            if not margins or min(margins) >= GRAZING_MARGIN:
                fail(f"K1 {label}: lane {r} winners {ik[r]} vs {ip[r]} "
                     f"is not grazing (margins {margins})")
    if not torch.allclose(t_k[same], t_p[same], rtol=T_RTOL, atol=T_ATOL):
        fail(f"K1 {label}: t differs beyond rtol/atol {T_RTOL}")
    err = (t_k[same] - t_p[same]).abs().max().item()
    k_ms = cuda_ms(lambda: intersect.nearest_t_idx_cm(o3, d3u, scene), 10)
    p_ms = cuda_ms(lambda: intersect.nearest_t_idx_plain(o3, d3u, tripack), 3)
    log(f"[2] K1 {label}: {o3.shape[1]} lanes x {tripack.shape[0]} tris, "
        f"winners agree {agree:.6f} ({len(bad)} grazing), t max abs err "
        f"{err:.3g}; kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
    report.append((label, err, k_ms, p_ms))


def check_k2(label, scene, point3, normal3, u, report) -> None:
    from pathtracerpython_tpu_torch.kernels import intersect, nee

    tripack = intersect.scene_tripack(scene)
    lightpack = nee.light_pack(scene)
    mc_k, occ_k = nee.nee_mean_cos_fused(point3, normal3, u, scene,
                                         NEE_SAMPLES)
    mc_p, occ_p = nee.nee_mean_cos_plain(point3, normal3, u, tripack,
                                         lightpack, NEE_SAMPLES)
    torch.cuda.synchronize()
    same = occ_k == occ_p
    agree = same.float().mean().item()
    if agree < MIN_OCC_AGREE:
        fail(f"K2 {label}: occlusion agrees on {agree:.6f} of lane-samples")
    lanes = same.all(dim=0)
    err = (mc_k[0][lanes] - mc_p[0][lanes]).abs().max().item()
    if err > MC_ATOL:
        fail(f"K2 {label}: mean cosine max abs err {err} > {MC_ATOL}")
    k_ms = cuda_ms(lambda: nee.nee_mean_cos_fused(
        point3, normal3, u, scene, NEE_SAMPLES), 10)
    p_ms = cuda_ms(lambda: nee.nee_mean_cos_plain(
        point3, normal3, u, tripack, lightpack, NEE_SAMPLES), 3)
    log(f"[2] K2 {label}: {point3.shape[1]} lanes x {NEE_SAMPLES} samples x "
        f"{int((tripack[:, 10] > 0.5).sum())} occluders, occlusion agrees "
        f"{agree:.6f}, mean cos max abs err {err:.3g}; kernel {k_ms:.3f} ms, "
        f"plain {p_ms:.3f} ms")
    report.append((label, err, k_ms, p_ms))


def phase2_kernels(scenes) -> tuple[list, list]:
    k1, k2 = [], []
    for name, scene in scenes:
        for b, (o3, d3u, p3, n3, u) in enumerate(
                wavefronts(scene, CORNELL_SPP), start=1):
            label = f"{name} bounce {b}"
            check_k1(label, scene, o3, d3u, k1)
            check_k2(label, scene, p3, n3, u, k2)
    return k1, k2


def phase3_render(scene) -> dict:
    from pathtracerpython_tpu_torch.kernels import intersect, nee
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import cornell_box_scene

    cfg = RenderConfig(mode="fast", n_samples=CORNELL_SPP,
                       n_bounces=CORNELL_BOUNCES,
                       n_light_samples=NEE_SAMPLES, batch_samples=True)
    intersect.LAUNCHES = 0
    nee.LAUNCHES = 0
    rad = render(scene, cfg, seed=0)
    torch.cuda.synchronize()
    launches = {"K1": intersect.LAUNCHES, "K2": nee.LAUNCHES}
    log(f"[3] Cornell stand-in {CORNELL_SIZE}x{CORNELL_SIZE}, {CORNELL_SPP} "
        f"spp, {CORNELL_BOUNCES} bounces: launches {launches}")
    for k, v in launches.items():
        if v != CORNELL_BOUNCES:
            fail(f"{k} launched {v} times in a {CORNELL_BOUNCES}-bounce render")
    if tuple(rad.shape) != (CORNELL_SIZE * CORNELL_SIZE, 3):
        fail(f"radiance shape {tuple(rad.shape)}")
    if not torch.isfinite(rad).all():
        fail("radiance has non-finite values")
    if (rad < 0).any():
        fail("radiance has negative values")
    if rad.min() == rad.max():
        fail("radiance is constant")
    log(f"[3] radiance finite, >= 0, mean {rad.mean().item():.6f}, "
        f"range [{rad.min().item():.6f}, {rad.max().item():.6f}]")

    small_scene = pack_scene(cornell_box_scene(32, 32), pad_to=32)
    small_cfg = RenderConfig(mode="fast", n_samples=2, n_bounces=4,
                             n_light_samples=NEE_SAMPLES, batch_samples=True)
    on_card = render(small_scene.to("cuda"), small_cfg, seed=0).cpu()
    on_cpu = render(small_scene, small_cfg, seed=0)
    close = torch.isclose(on_card, on_cpu, rtol=RENDER_RTOL,
                          atol=RENDER_ATOL).all(dim=1)
    share = close.float().mean().item()
    diff = (on_card - on_cpu).abs().max().item()
    log(f"[3] 32x32x2spp card vs CPU: {share:.4f} of pixels within "
        f"rtol/atol {RENDER_RTOL}, max abs diff {diff:.3g}")
    if share < MIN_PIXELS_CLOSE:
        fail(f"card and CPU renders agree on only {share:.4f} of pixels")
    return launches


def time_render(label, scene, spp, bounces) -> dict:
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render

    cfg = RenderConfig(mode="fast", n_samples=spp, n_bounces=bounces,
                       n_light_samples=NEE_SAMPLES, batch_samples=True)
    seeds = iter(range(1000))
    times = timed_runs(lambda: render(scene, cfg, seed=next(seeds)),
                      warmup=2, reps=10)
    ms = statistics.median(times)
    pixels = scene.meta.width * scene.meta.height
    segments = pixels * spp * bounces
    all_rays = segments * (1 + NEE_SAMPLES)
    row = {
        "cell": label, "triangles": scene.meta.n_triangles,
        "padded_triangles": scene.num_padded_triangles,
        "ms_per_render": ms, "ms_min": min(times), "ms_max": max(times),
        "mrays_per_s_all": all_rays / (ms * 1e3),
        "mrays_per_s_segments": segments / (ms * 1e3),
    }
    log(f"[4] {label}: {ms:.3f} ms/render (median of 10; min {min(times):.3f},"
        f" max {max(times):.3f}); {row['mrays_per_s_all']:.2f} Mrays/s all "
        f"rays, {row['mrays_per_s_segments']:.2f} Mrays/s path segments")
    return row


def profile_render(label, scene, spp, bounces, render_ms) -> dict:
    """One render under torch.profiler: device-busy time split into K1, K2
    and PyTorch's own kernels, the device's idle share against the untraced
    median ``render_ms``, and the busiest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render

    cfg = RenderConfig(n_samples=spp, n_bounces=bounces,
                       n_light_samples=NEE_SAMPLES, batch_samples=True)
    render(scene, cfg, seed=0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render(scene, cfg, seed=1)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not kernels:
        fail(f"profile {label}: the trace shows no device kernel")
    busy_us = {"K1": 0.0, "K2": 0.0, "torch": 0.0}
    for e in kernels:
        group = ("K1" if "nearest_kernel" in e.key else
                 "K2" if "nee_kernel" in e.key else "torch")
        busy_us[group] += e.self_device_time_total
    busy_ms = sum(busy_us.values()) / 1e3
    row = {
        "cell": label, "traced_wall_ms": traced_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / render_ms,
        "kernel_launches": sum(e.count for e in kernels),
        **{f"{k}_ms": v / 1e3 for k, v in busy_us.items()},
    }
    log(f"[profile] {label}: device busy {busy_ms:.3f} ms of the untraced "
        f"{render_ms:.3f} ms (idle share {row['idle_share']:.3f}); K1 "
        f"{row['K1_ms']:.3f} ms, K2 {row['K2_ms']:.3f} ms, PyTorch kernels "
        f"{row['torch_ms']:.3f} ms in {row['kernel_launches']} device "
        f"kernels; traced wall {traced_ms:.3f} ms")
    log(prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=12, max_name_column_width=60))
    return row


def main() -> None:
    card, name = phase0_identity()
    phase1_build()

    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import (
        box_field_scene,
        cornell_box_scene,
    )

    cornell = pack_scene(cornell_box_scene(CORNELL_SIZE, CORNELL_SIZE),
                         pad_to=32).to("cuda")
    field = pack_scene(box_field_scene(n_boxes=FIELD_BOXES,
                                       width=CORNELL_SIZE,
                                       height=CORNELL_SIZE)).to("cuda")
    log(f"[2] scenes: Cornell stand-in ({cornell.meta.path}, "
        f"{cornell.meta.n_triangles} tris) and box field "
        f"({field.meta.n_triangles} tris, {field.num_padded_triangles} "
        "padded); no scene file is read")
    k1, k2 = phase2_kernels([("cornell", cornell), ("boxfield", field)])
    launches = phase3_render(cornell)
    cells = [
        time_render(f"cornell {CORNELL_SIZE}^2 {CORNELL_SPP}spp "
                    f"{CORNELL_BOUNCES}b", cornell, CORNELL_SPP,
                    CORNELL_BOUNCES),
        time_render(f"boxfield{FIELD_BOXES} {CORNELL_SIZE}^2 {FIELD_SPP}spp "
                    f"{FIELD_BOUNCES}b", field, FIELD_SPP, FIELD_BOUNCES),
    ]
    log("[4] cells " + json.dumps(cells))
    if "--profile" in sys.argv[1:]:
        rows = [
            profile_render(c["cell"], scene, spp, bounces, c["ms_per_render"])
            for c, scene, spp, bounces in (
                (cells[0], cornell, CORNELL_SPP, CORNELL_BOUNCES),
                (cells[1], field, FIELD_SPP, FIELD_BOUNCES))
        ]
        log("[profile] " + json.dumps(rows))

    # the main path's shapes: the Cornell primary wavefront
    kernels = []
    for entry, rows, src, replaces in (
        ("K1 nearest_t_idx_cm", k1, "pathtracerpython_tpu_torch/csrc/nearest.cu",
         "pathtracerpython_tpu/kernels/intersect_pallas.py:489"),
        ("K2 nee_mean_cos_fused", k2, "pathtracerpython_tpu_torch/csrc/nee.cu",
         "pathtracerpython_tpu/kernels/nee_pallas.py:226"),
    ):
        kernels.append({
            "name": entry, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[entry[:2]],
            "max_abs_err": max(r[1] for r in rows),
            "ms": rows[0][2], "plain_ms": rows[0][3],
        })
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
