#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout
    python3 chip_smoke.py --profile  # also profiles one render of each cell
    python3 chip_smoke.py --only 3p  # phases 0, 1 and 3p alone, without
                                     # the result lines
    python3 chip_smoke.py --only 3p --world 4   # phase 3p on 4 ranks: on
                                     # 4 cards, a card and NCCL each

Drives ``pathtracerpython_tpu_torch`` through its public entry points on the
card, in the phases below, and fails (non-zero exit, no result line) if any
phase fails:

0. card identity: ``nvidia-smi`` name and power limit, torch and CUDA
   versions; no CUDA device is an error;
1. build: compiles ``pathtracerpython_tpu_torch/csrc/*.cu`` with nvcc, one
   process per source, in parallel;
2. kernel against plain, with CUDA-event times of both:
   - K1 (dense nearest hit), K2 (fused NEE) and K4 (dense any-hit, on the
     unfused NEE's shadow rays) on the first and second bounce wavefronts
     of the 512x512x4spp render (1,048,576 lanes), for the Cornell stand-in
     and a 300-box field (3,604 triangles, still dense). Every dense sweep
     culls by boxes. K1 and K3's dense nearest (bound: the lane's running
     best t) are held against their culled plain model run on the card
     (winners and t equal on every lane, max abs diff 0; a lane that
     differs is printed with its ray, both winners and their barycentric
     margins) and against their un-culled plain version under K1's bounds
     below, with the number of lanes that differ. K2, K4 and K3's dense
     any-hit are held against their un-culled plain version bit for bit
     (max abs diff 0 on every lane; a lane that differs is printed with its
     ray, limit and blocking triangle). Each counting instance gives the
     same result and reports the pairs it tested and the shares of tiles
     and groups it skipped. The same on a morton-ordered pack of the box
     field, whose bits and t must be the scene-order run's, the winners
     naming the same triangles (but for a tie on an edge two triangles
     share); K4 and K3's dense any-hit also on the wavefronts of the
     300-box field's render with 9 NEE samples (256x256, 589,824 shadow
     lanes), the multi-tile render that launches K4;
   - K5 (cluster-sparse nearest) and K9 (walker any-hit) on the sorted,
     parked first and second bounce wavefronts of the 100k-triangle box
     field at 512x512x2spp (524,288 path lanes, 1,572,864 shadow lanes):
     each against its plain version on a subset of ray blocks, and against
     the dense K1 / K4 on the whole wavefront, which shows whether the
     hierarchy culls and that its per-ray gate drops no hit. The culled
     dense K1 there is held against its un-culled plain version on every
     SUBSET_STRIDE-th block of 1024 lanes, and its time is printed beside
     K5 at 1024 and 512 and K8 on the same wavefront;
   - on the same wavefronts K8 (walker nearest) against its plain version,
     K1 and K5; K5 in blocks of 512 beside 1024. K5, K8 and K3's sparse
     nearest walk each block's list in units of WALK_SEGMENT slots on many
     CTAs (the split walk): their counting instances give the units
     launched and stopped before their first slot, which must be the units
     the lists give, and their (ray, cluster) visits, which must lie in
     their band (at least what each lane needs up to its winner, at most
     what the units visit when each starts from nothing) and are printed
     beside the serial walk's; with each wavefront's longest list and the
     blocks that hold a missing live lane, straddle two direction octants
     or hold the park edge. K6 (cluster-sparse any-hit), K9 and K3's
     sparse any-hit run the split any-hit walk with the in-cluster box cull
     (csrc/any_hit_walk.cuh): each against its culled plain model on the
     checked blocks and against K4 (K3's against the dense Plücker any-hit)
     and each other on all lanes, bit for bit; their counting instances
     give the units those the lists give, and visits, box tests by level
     and pairs tested inside their band on every SUBSET_STRIDE-th block,
     with the kernel's time on all blocks and without the 1% longest
     lists. K7 (the any-hit that reports the first blocking cluster) runs
     the same walk merged by each lane's first blocking slot: on the full
     lists against its culled plain model (bits and clusters equal on
     every checked lane), against the un-culled plain version (clusters
     on MIN_CL_AGREE of lanes) and against K6 on all lanes, with its
     counting instance inside the band; its two-pass protocol with a cold
     cache, the cache it returned and the cache the render carries, its
     bits K6's on all lanes, each pass (the vote-ordered guess lists, then
     the lanes left open) held to its culled model and timed alone, and
     the compaction between them (the compact entry of csrc/two_pass.cu)
     bit for bit its plain twin and torch.nonzero's order, timed against
     its bound and the library path it replaced (torch.nonzero and the
     gather);
   - the two-pass protocol of the uncached sweeps on the same wavefronts:
     K5 in blocks of 1024 and 512 and K6 over the first PASS1_K slots of
     each block's list, the select-and-compact kernel (csrc/two_pass.cu)
     against its plain twins bit for bit (flags, bound, slots, count,
     branch word and pass 2's rays) and torch.nonzero's order, the
     survivors swept again over their own lists; both branches (the one
     M_DIV takes and the other forced by m_div) equal to the one-pass
     kernel bit for bit, with the survivor share, pass 1, the kernel (and
     the library path it replaced: the flags, torch.nonzero and the
     gather), pass 2's lists, pass 2 and the fallback timed alone and the
     two-pass wrapper in turns with the one-pass one;
   - K3, the Plücker form of the four sweeps that follow the ``mt_impl``
     knob: dense nearest and dense any-hit on the Cornell and box-field
     wavefronts, cluster-sparse nearest and
     any-hit on the 100k field's sorted wavefronts; each against its plain
     version (the bounds of K1 / K4), the sparse sweeps against the dense
     Plücker sweep (max abs diff 0), and each against its classic twin
     (winners or bits differ on < 0.2% of lanes, every such lane within
     1e-4 of an edge in float64, t within 2e-4), with the classic twin's
     time from the same run beside it;
   - the probes P1 (classic, Plücker on the CUDA cores, Plücker with one
     pass and with three passes of TF32 wgmma, the Plücker ones sign test
     first; 262,144 rays x 512 triangles) and P2 (the classic test in
     float32 and packed bf16; 2^20 rays x 512 triangles): every variant
     against its plain version and its bound (the plane counted on the
     pairs whose sides agree), then the probes' own entry points, whose
     JSON lines are printed;
   - scatter_rows (csrc/scatter_rows.cu, the sum of every table gradient)
     on the calls one backward of the bench training step makes, captured
     (the triangle pack onto 64 rows, the light table onto 2, mat_rgb), on
     the 100k field's tri_v0 backward (onto 100,096 rows) and on 2^20 x 9
     lanes onto 3, 4, 113 and 114 rows (each side of its paths' limits),
     each row naming its path (tiny, narrow or wide): bit for bit its
     order's model ``gather.scatter_rows_model``, the same bits in four
     launches (one on a second stream), no stream sync in the call, within
     1e-6 of the absolute sum from the float64 sum and from its plain
     version; its time beside the plain version's, the float32 weighted
     bincount's (the library call), index_add_'s and a stable sort's of
     the rows (which only the wide path runs);
   - the RNG (csrc/threefry.cu, ``ops/rng.py:uniforms`` on the card) on
     a 16-spp chunk's 4,194,304 int64 path counters, a bounce's two
     calls (15 and 3 draws): bit for bit its plain version, one launch a
     call, its time beside the plain version's and its bound (the
     counters and draws once over the memory rate, or the hashes' integer
     operations over PEAK_INT32_OPS);
3. the full renders, in each of which the RNG kernel launches twice a
   bounce of each sample pass, as in every render on the card counted below:
   - Cornell stand-in at 512x512, 4 spp, 4 bounces, 3 NEE samples:
     radiance finite, non-negative and not constant; K1 and K2 launched
     exactly once per bounce; the same render with the plain draws
     (``rng.uniforms_plain``) bit for bit; a 32x32 render on the card
     held against the same render on the CPU (the plain versions);
   - the 100k-triangle box field at 512x512, 2 spp, 3 bounces
     (accel="auto", the hybrid): the same radiance checks; K5 and K9
     launched once per bounce, K1, K2 and K4 never (the lists are
     complete, so no dense fallback exists); the same render with
     accel="sparse" (K5, K6), with nee_cache="on" added (K5, K7 twice per
     bounce, the select-and-compact kernel's compact entry once) and with
     accel="walker" (K8, K9), each within 1e-6 of the hybrid's radiance,
     with its launch counts; the sparse and hybrid renders again with both
     two-pass auto flags on, each equal to its default render bit for bit
     and timed in turns with it, with the launches of K5, K6 and the
     select-and-compact kernel;
   - the 300-box field at 128x128 with accel="hybrid" against
     accel="none" on the card, a 400-box field's hybrid render on the
     card against the CPU (also sparse with the cache, and walker), and
     the Cornell stand-in with a 72-triangle light (unfused NEE, K4 once
     per bounce), and the 300-box field at 256x256, 1 spp, 2 bounces with 9
     NEE samples (over the fused NEE's 8, so the unfused NEE runs K4 once
     per bounce on a scene of 15 tiles; also 32x32 on the card against the
     CPU);
   - under ``mt_impl="plucker"``: the Cornell stand-in (K3's dense nearest
     once per bounce, K1 never, K2 as before), the 100k field through
     accel="sparse" (K3's sparse nearest and any-hit, K5 and K6 never) and
     the hybrid (K3's sparse nearest, K9), and the 72-triangle-light
     Cornell (K3's dense any-hit), each held against the classic render of
     the same cell (mean abs diff < 1e-3, 99.9th percentile < 0.05) and,
     at 32x32, against the CPU render;
3g. gradients (the training path; every check fails the run):
   - the slice through its entry point: ``apps.fit_albedo.run`` on the
     card for 10 steps (the Cornell stand-in at 128x128, 2 spp, 2 bounces,
     3 NEE samples; ``mat_rgb`` and ``light_color`` by Adam): the losses
     are printed and must fall; K1 and K2 launched once per sample pass
     and bounce of each step and of its two renders, and no kernel in the
     backwards;
   - step 0 of that configuration on the card against the plain versions
     on the CPU: the gradients of mat_rgb, light_color, ambient, tri_v0,
     light_v0, eye and ortho within GRAD_RTOL in relative L2 per field;
   - K1 under ``NearestTIdx`` and K2 under ``NeeMeanCos`` give the no-grad
     call's t, idx, mc and occ bit for bit on the Cornell camera's 512x512x4
     lanes, and their backwards (K3's dense nearest's too) are timed
     alone there;
   - one training step at the bench configuration (Cornell 512x512, 4 spp,
     4 bounces, 3 NEE samples, batch_samples) with material, emission and
     vertex params: ms of the forward alone, of forward and backward, of a
     whole step and of the no-grad render (CUDA events, median of 10 after
     2 warm-ups), the fwd:bwd ratio, the peak memory, the launches of one
     step, its gradients bit-equal over three runs, one audited backward
     (below), the stream syncs of one backward with the kernel and with
     the weighted bincount it replaced, and one backward under
     torch.profiler (device busy, top operators);
   - tri_v0's gradient on the 100k field at 128x128 through accel="auto"
     (K5, K9 detached), "walker" (K8) and "sparse" under
     ``mt_impl="plucker"`` (K3's sparse nearest) against accel="none" (K1;
     K3's dense nearest for the Plücker form) within GRAD_RTOL, each run
     twice for the same bits and each hierarchy's backward audited, and
     the backward of K5's, K8's and K3's sparse nearest sweep timed alone
     on the field's primary rays and pack;
3s. soft and pose (the soft estimator is plain PyTorch, as the JAX
   package's is plain XLA: no kernel of its own; every check fails the
   run):
   - a soft render of the stand-in at 128x128 (1 spp, 1 bounce, beta 0.03)
     launches none of K1-K9;
   - the occluder scene of ``tests/test_boundary.py`` and the stand-in at
     64x64 (beta 0.05): soft radiance on the card against the CPU (the
     Cornell rule), and at 1 bounce the gradients of the blocker's
     translation and of the tall cube's planar pose within GRAD_RTOL, over
     the pixels whose front record does not tie between two coplanar
     triangles (there it follows the last bit of t);
   - the 600-box field (7,296 triangles, morton) at 128x128, beta 0.03:
     the cluster soft sweep's records equal to the dense sweep's on every
     camera ray and on shadow rays from 16 floor patches, its visibility
     within 5e-3 of the dense one, no dense fallback; ms, peak memory and
     fallbacks of one soft render and its backward, which is audited;
   - ``apps.fit_pose.run(object_name="cube")`` with the app's defaults
     (planar, 120 steps a level, pyramid 40x40 then 128x128, 4 beta stages
     0.12 -> 0.03, 1 spp, 1 bounce) at Adam(0.03), seeds 0-2: at each
     level the loss of its last beta stage (one objective, one key) is
     lower at the pose the level ended with than at the fit's initial
     pose, and one seed recovers the pose; ms a step, fwd:bwd, peak;
   - ``fit_pose`` light mode (30 steps) and ``apps.fit_camera`` (20): the
     lateral and eye errors fall, K1 and K2 launched once per sample pass
     and bounce of each step and render (none in the backwards);
   - the soft pose step at 4 spp and fit_camera's first step, each run
     twice for the same bits and audited once;
   - the training step of the bench configuration with ``remat_bounces``
     off and on: gradients within 1e-6 relative L2 per field, K1 and K2 4
     then 8 launches a step, peak memory and ms a step both ways;
   - the soft pose step at 1, 2, 4 and 8 spp at 128x128: ms and peak
     memory (the port's sample loop is Python, with no compile cost);
3r. reference mode, the CLI, the native loader and checkpointed fits
   (reference mode is plain PyTorch: the JAX package's reference sweeps
   are XLA's and reach no pl.pallas_call; every check fails the run):
   - the stand-in at its native 40x40, 64 spp, 1 and 2 bounces, in
     reference mode on the card against the CPU: no kernel launched; at 1
     bounce the light pixels and the black ones equal; radiance within
     RENDER_RTOL on MIN_PIXELS_CLOSE of pixels;
   - reference mode at the bench configuration (the Cornell cell): ms per
     render (CUDA events, 2 warm-ups, median of 10, min and max), peak
     memory, device busy under torch.profiler, and fast mode's ms beside
     it, timed in turns;
   - the CLI on the stand-in's SDL written by ``synthetic.write_sdl``:
     in-process in both modes with the launch counts set to 0 just before
     and read just after (K1 and K2 once per sample pass and bounce in fast
     mode, no kernel in reference mode); as ``python -m
     pathtracerpython_tpu_torch`` subprocesses on the card in fast mode
     with ``--metrics`` (its JSON printed) and in reference mode, each PNG
     decoding to ``render_image``'s pixels; ``--ckpt-dir`` stopped after
     chunk 2 of 4 and resumed, its accumulation bit-equal to an
     uninterrupted run's;
   - the native OBJ loader (built from native/objparse.cpp at first use):
     whether it was used, its parse time and the Python parser's on a
     100,000-triangle box field written as OBJ, packed leaves equal;
   - ``fit_albedo --checkpoint-every 5`` for 10 steps, stopped at step 5
     and resumed: the loss falls, and the losses and the final params are
     the uninterrupted run's bit for bit;
3p. parallel/ on torch.distributed (every check fails the run; the card is
   one GPU, so two ranks share it and talk through gloo with host staging,
   and their ms are the machinery's cost, not scaling; the kernel library
   is built in phase 1, before any rank starts; the phase's seconds are
   printed):
   - two ranks (``chip_smoke.py --parallel-rank R``), each first probing
     which gloo collectives take CUDA tensors, then:
     - dp = 2 at the Cornell cell's configuration: the gathered image
       bit-equal to the single-device render, K1 and K2 4 launches a rank,
       ms a render a rank beside the single-device ms in turns;
     - geom = 2 on the 100k field (512x512, 2 spp, 3 bounces): within
       1e-6 of the single-device hybrid render, K1 and K4 launched bounces
       x ring steps times a rank, ms a render, the ring's shifts and bytes;
     - pp = 2 on the Cornell cell's scene (4 spp, 4 bounces): bit-equal to
       the single-device batch_samples=False render, ms a render;
     - the sharded training step, dp = 2 and geom = 2, on the stand-in at
       128x128 (mat_rgb, light_color, eye; Adam(1e-2)): loss within rtol
       1e-6, params within rtol 1e-5 / atol 1e-7 of the single-device step;
       each audited once;
     - the ring train step: the Cornell cell (512x512, 4 spp as lanes, 4
       bounces, 3 NEE, 64 rows) with material, emission, vertex and
       light-vertex params under geom = 2 (dp = ranks / 2): loss within
       1e-6 and each field's gradient within 1e-4 relative L2 of one
       device; tri_v0's gradient of the rank's own rays non-zero on rows it
       does not own, and its home rows' gradient that of its ring's rays,
       the other ranks' part included; bounces x (geom - 1) reverse shifts;
       ms a step in turns with the single step, bytes forward and backward,
       launches and peak memory; the step again on each rank, bit-equal,
       and audited once;
     - the soft ring: the soft pose step (the stand-in at 128x128, beta
       0.03, 1 bounce, 3 NEE, 4 spp; radiance within 1e-5, pose gradient
       within 1e-4 relative L2 of one device), and the soft 600-box field
       (128x128, 1 spp, 1 bounce) render and tri_v0 backward against one
       device's dense soft sweeps (radiance within 1e-5, gradient within
       1e-4 relative L2);
   - the CLI under torchrun with --dp 2: its PNG equal to one process's;
   - ``entry.dryrun_multichip(2)``, which starts its own two ranks;
   - a one-rank NCCL group: one all-gather through the port's transport;
4. timing: ms per render (CUDA events, 2 warm-up renders, median of 10)
   and Mrays/s counted two ways, for the Cornell cell, the 300-box field
   and the 100k-triangle field through the hybrid, sparse, sparse with
   the cache, and walker hierarchies (the last two with 5 timed renders),
   the Cornell, sparse and hybrid cells under ``mt_impl="plucker"``, and the
   300-box field with 9 NEE samples.

The next-to-last line is a JSON object with one entry per kernel: its
launches on its main path, its error against its plain version, its time,
the plain version's, and its bound: the larger of bytes (inputs read once,
outputs written once) over 3.35 TB/s and ray-triangle pairs x flops per
pair over 67 TFLOP/s (float32 outside the tensor cores; 495 TFLOP/s for the
TF32 mma of P1, twice the float32 rate for P2's packed bf16), the pairs
being what this run's data needs. For the culled sweeps that is: in K2, K4
and K3's dense any-hit, for a lane that ends unoccluded the occluders whose
own box its segment meets under the kernels' slab test, for an occluded
lane one; in K1 and K3's dense nearest, for a lane that hits the valid rows
whose own box its ray meets up to its winner's t, for a lane that misses
those its whole ray meets; in the split any-hit walks (K6, K9, K3's
sparse any-hit, K7), for a lane that ends unoccluded the pairs its culled
model tests in every cluster its gate lets through, for an occluded lane
one, with the bound of the gate's pairs (128 a visit) beside it as
``gate_pairs_bound_ms``; their bytes are the rays, the outputs, each
list's first ``ncand`` slots and, once for each cluster the lists name,
the columns of its rows that a pair test reads and its box (not the pack's
padding, not the in-cluster cull boxes). The kernels' groups hold those boxes, so a
kernel cannot test fewer, and the run fails if any kernel reads under its
bound. The earlier reckoning (every occluder for an unoccluded lane, every
row for a nearest lane) stays in those rows as ``all_pairs_bound_ms``,
beside the pairs tested, needed and all and the shares of tiles and groups
skipped. The library is built with -fmad=false, so the 67 TFLOP/s, which
count a fused multiply-add as two, are twice what its un-fused code can
reach. No single PyTorch call computes a ray-triangle sweep, so the
sweeps' ``library_ms`` is null; scatter_rows' is the float32 weighted
bincount's. Each row names its kernel's ``backward``: the
nearest sweeps' (K1, K3's nearest sweeps, K5, K8) and the fused NEE's (K2)
re-solve in plain PyTorch, with ``backward_ms``, one call on the kernel's
own wavefront and pack (K1, K3's dense nearest and K2 the Cornell bench's
primary rays, K5, K8 and K3's sparse nearest the 100k field's); "none
(detached)" for the any-hits.

An audited backward (every gradient path above) runs once more as a
check-only pass under ``utils.determinism.SumAudit`` and
``torch.use_deterministic_algorithms(True, warn_only=True)``, set for the
pass alone: it fails the run if a float sum adds two lanes into one
address (the order a device's atomics would choose), and the line before
the card's name lists each path's sums and the ops torch flags. Every
"[bits]" line is a gate. The last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
# The 100k-triangle box field of the JAX package's scripts/bench_large.py:
# 8,333 boxes (100,000 triangles) in morton order, 512x512, 2 spp carried
# as extra lanes, 3 bounces, 3 NEE samples, accel="auto" (the hybrid).
LARGE_BOXES = 8333
LARGE_SPP = 2
LARGE_BOUNCES = 3
HYBRID_CHECK_SIZE = 128  # the 300-box field, hybrid against dense
# The 300-box field through the unfused NEE: more light samples than the
# fused NEE takes, so K4 sweeps a scene of 15 tiles once per bounce.
MANY_NEE_SAMPLES = 9
MANY_NEE_SIZE = 256
MANY_NEE_SPP = 1
MANY_NEE_BOUNCES = 2
MANY_NEE_LABEL = "boxfield 9nee"  # its wavefronts' rows of phase 2
# K5/K9 against their plain versions: every ray block of the first bounce,
# every SUBSET_STRIDE-th block of the second.
SUBSET_STRIDE = 8

# The port is read from the checkout that holds this script, never from
# another installation.
ROOT = os.path.dirname(os.path.abspath(__file__))

# Kernel against plain on the card. Both compute the same float32 ops in
# the same order (the kernels are built with -fmad=false), so they should
# agree bit for bit; the bounds leave room for boundary-grazing lanes only.
MIN_IDX_AGREE = 0.9999       # K1: share of lanes with the same winner
T_RTOL = T_ATOL = 1e-6       # K1: t on lanes with the same winner
GRAZING_MARGIN = 1e-5        # K1: float64 barycentric margin of a mismatch
MIN_OCC_AGREE = 0.9999       # K6, K7, K9: share of equal occlusion bits
MIN_CL_AGREE = 0.9999        # K7: share of lanes with the same blocking cluster
VARIANT_ATOL = 1e-6          # sparse / cached / walker render against hybrid
MC_ATOL = 1e-5               # K2: mean cosine on lanes whose bits agree
# K3 against its classic twin: the two forms round differently, so winners
# and bits may differ, but only on rays that graze an edge (the contract of
# the JAX package's tests/test_plucker.py).
FORM_MIN_AGREE = 1.0 - 2e-3  # share of lanes with the same winner or bit
FORM_MARGIN = 1e-4           # float64 barycentric margin of a mismatch
FORM_T_TOL = 2e-4            # t on lanes with the same winner
# A Plücker render against the classic render of the same cell.
POP_MEAN = 1e-3              # mean abs radiance difference
POP_Q999 = 0.05              # its 99.9th percentile
# P1's TF32 variants against their plain versions: the tensor core sums the
# eight products in its own order, so a side within an ulp of 0 may flip.
MMA_MIN_AGREE = 0.999
# Card against CPU at 32x32: the CPU's rsqrt, sin and cos round differently
# in the last bit; the scene keeps those ulps from flipping discrete events.
RENDER_RTOL = RENDER_ATOL = 1e-4
MIN_PIXELS_CLOSE = 0.99

# The card's published peaks (H100 SXM, 700 W): float32 outside the tensor
# cores, and device memory.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Float adds, subtracts, multiplies and divides of one Möller–Trumbore
# ray-triangle test in csrc/mt.cuh (comparisons and selects not counted):
# 46 in mt_core (pvec 9, det 5, 1/det 1, tvec 3, u 6, qvec 9, v 6, t 6,
# u + v 1), which the tile kernels K1, K2 and K4 run on edges precomputed
# once per tile; the cluster walks K5-K9 form the two edges per pair, 6
# more.
FLOPS_PER_PAIR_TILE = 46
FLOPS_PER_PAIR_ROW = 52
# The Plücker test of csrc/plucker.cuh on a precomputed 36-column row: three
# sides of 6 products and 5 adds (33), n.d 5, the numerator 8, 1 division.
FLOPS_PER_PAIR_PLUCKER = 47
# P1's Plücker variants test the sides' signs first: the three sides on
# every pair (33 float32 operations on the CUDA cores: 6 products and 5
# adds a side; or 3 sides x 6 multiply-adds x 2 on the tensor cores per
# pass, the edges' two zero pad columns not counted, as the function does
# not need them), the plane's 14 float32 operations (n.d 5, the numerator
# 8, 1 division) only on the pairs whose sides agree
# (mma_probe.inside_pairs).
PEAK_TF32_FLOPS = 495e12
SIDE_FLOPS_PER_PAIR = 33
MMA_FLOPS_PER_PAIR = 36
PLANE_FLOPS_PER_PAIR = 14
# what P1's rows add to the kernels line: the pairs whose sides agree
PROBE_KEYS = ("pairs", "inside_pairs")
# P2's packed bf16 on the CUDA cores: two values a lane, so twice the
# float32 rate (the card's data sheet has no row of its own for it).
PEAK_BF16_CORE_FLOPS = 2 * PEAK_FP32_FLOPS
C_TRI = 128
OCCLUDER_COL = 10  # of the [T, 12] pack (kernels/intersect.py)
# The floats of a pack row that a pair test of a shadow walk reads, by the
# pack's width: the classic row's v0, v1, v2, valid and occluder (of 12);
# the Plücker row's three edges (direction and moment), n, v0, valid and
# occluder (of 36). The rest is padding. A cluster box is min.xyz | max.xyz
# of 8 floats.
ROW_FLOATS = {12: 11, 36: 26}
BOX_FLOATS = 6


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs, by CUDA events.
    ``queued``: the stream is held by a spin kernel (about 0.25 ms a run,
    past the host time of a call of ten launches) while the host queues the
    runs, so a call whose host side outlasts its device work reads its
    device time; a call that reads back to the host waits for the device
    each time and reads as without."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(500_000 * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def list_bytes(lists, pack) -> int:
    """The bytes a cluster any-hit walk over ``lists`` must read: each
    block's first ``ncand`` slots (id and key) and its count, and once for
    every cluster that some list names, what a pair test reads of its
    C_TRI rows of ``pack`` (``ROW_FLOATS`` of a row) and the BOX_FLOATS of
    its box. Not counted: the pack's padding columns, and the in-cluster
    cull boxes, which the walk reads only because of its own design."""
    slots = (torch.arange(lists.ids.shape[1], device=lists.ids.device)[None]
             < lists.ncand[:, None])
    named = int(lists.ids[slots].unique().numel())
    per_cluster = (C_TRI * ROW_FLOATS[pack.shape[1]] + BOX_FLOATS) * 4
    return (int(slots.sum()) * (lists.ids.element_size()
                                + lists.keys.element_size())
            + tensor_bytes(lists.ncand) + named * per_cluster)


def bound(nbytes: int, pairs: int, flops_per_pair: int) -> tuple[float, str]:
    """The least milliseconds the card could take: ``nbytes`` over its
    memory rate or ``pairs`` ray-triangle tests over its float32 peak,
    whichever is larger, and which of the two it is."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    by_ops = pairs * flops_per_pair / PEAK_FP32_FLOPS * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                              "bytes")


def bound_ops(nbytes: int, ops_ms: float) -> tuple[float, str]:
    """``bound`` for work whose operations are of more than one type:
    ``ops_ms`` is the sum of each type's count over its peak rate."""
    by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= by_bytes else (by_bytes,
                                                               "bytes")


def report_row(label, err, ms, plain_ms, bound_, **extra) -> dict:
    return {"label": label, "err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_[0], "bound_by": bound_[1], **extra}


def timed_runs(fn, warmup: int, reps: int) -> list[float]:
    """Milliseconds of each of ``reps`` runs of ``fn()`` after ``warmup``
    untimed runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        times.append(cuda_ms(fn, 1))
    return times


def timed(phase: str, fn, *args):
    """``fn(*args)``, with a line of the phase's wall seconds after it (the
    script's limit is 1,200 s)."""
    start = time.monotonic()
    out = fn(*args)
    log(f"[time] {phase}: {time.monotonic() - start:.1f} s")
    return out


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


def wavefronts(scene, spp: int, nee_samples: int = NEE_SAMPLES, **cfg_kw):
    """Inputs of the kernels on the first and second bounce wavefronts of
    the scene's batch_samples render with ``nee_samples`` light samples
    (``cfg_kw``: further RenderConfig fields), sorted and parked where the render sorts (the cluster
    hierarchies): [(o3, d3u, point3, normal3, u_nee, shadow, nee_cache)],
    ``shadow`` the unfused NEE's shadow rays of the wavefront
    (``integrator.ShadowRays``: parked and sorted where the render does),
    ``nee_cache`` the occluder cache the wavefront's lanes carry."""
    from pathtracerpython_tpu_torch.ops import rng
    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
    from pathtracerpython_tpu_torch.ops.geometry import (
        nearest_hit_cm,
        normalize3,
    )
    from pathtracerpython_tpu_torch.ops.sort import scene_bounds
    from pathtracerpython_tpu_torch.render import integrator
    from pathtracerpython_tpu_torch.render.config import RenderConfig

    cfg = RenderConfig(n_samples=spp, n_bounces=2,
                       n_light_samples=nee_samples, batch_samples=True,
                       **cfg_kw)
    sort_bounds = (scene_bounds(scene)
                   if integrator._sort_enabled(scene, cfg) else None)
    w, h = scene.meta.width, scene.meta.height
    origins, dirs = make_primary_rays(scene.eye, scene.ortho, w, h)
    pid = torch.arange(w * h, device=scene.device)
    counters = torch.cat([pid * spp + s for s in range(spp)])
    state = integrator.init_rays(origins.T.repeat(1, spp),
                                 dirs.T.repeat(1, spp), counters)
    k0, k1 = rng.key_from_seed(0)
    out = []
    for b in range(2):
        st, o3, d3 = integrator.sort_and_park(state, sort_bounds)
        nk = rng.fold(k0, k1, b * 4 + integrator._P_NEE)
        u_nee = rng.uniforms(*nk, st.counters, nee_samples * 5)
        hit = nearest_hit_cm(o3, d3, scene, accel=cfg.accel)
        shading = integrator.arrival_side_normal(hit.normal3,
                                                 normalize3(st.direction3))
        shadow = integrator.nee_shadow_rays(
            hit, u_nee, scene, cfg, shading,
            st.alive & hit.hit & ~hit.is_light, st.nee_occ_hint)
        out.append((o3, normalize3(d3), hit.point3, shading, u_nee, shadow,
                    st.nee_cache))
        state = integrator.bounce_step(state, b, scene, cfg, k0, k1,
                                       sort_bounds)
    return out


def check_winners(what, tripack, o3, d3u, t, idx, want_t, want_idx,
                  min_agree=MIN_IDX_AGREE, margin=GRAZING_MARGIN,
                  t_tol=T_RTOL):
    """K1's bounds (or looser ones given): winners equal on ``min_agree``
    of lanes, every mismatch within ``margin`` of an edge, t within
    rtol = atol = ``t_tol`` on equal winners. Returns (share of equal
    winners, grazing mismatches, t max abs error)."""
    same = idx == want_idx
    agree = same.float().mean().item()
    if agree < min_agree:
        fail(f"{what}: winners agree on {agree:.6f} of lanes")
    bad = torch.nonzero(~same).flatten().cpu().numpy()
    if len(bad):
        pack = tripack.cpu().numpy()
        o_np, d_np = o3.cpu().numpy(), d3u.cpu().numpy()
        ik, ip = idx.cpu().numpy(), want_idx.cpu().numpy()
        for r in bad:
            margins = [abs(bary_margin_f64(pack, o_np[:, r], d_np[:, r], i))
                       for i in (ik[r], ip[r]) if i >= 0]
            if not margins or min(margins) >= margin:
                fail(f"{what}: lane {r} winners {ik[r]} vs {ip[r]} is not "
                     f"grazing (margins {margins})")
    if not torch.allclose(t[same], want_t[same], rtol=t_tol, atol=t_tol):
        fail(f"{what}: t differs beyond rtol/atol {t_tol}")
    return agree, len(bad), (t[same] - want_t[same]).abs().max().item()


def hold_winners(what, tripack, o3, d3u, t, idx, want_t, want_idx) -> None:
    """Winners and t equal to ``want`` on every lane (max abs diff 0); else
    print up to 8 lanes that differ, each with its ray, both winners, their
    t and their float64 barycentric margins, and fail."""
    bad = torch.nonzero((idx != want_idx) | (t != want_t)).flatten()
    if not len(bad):
        return
    pack = tripack.cpu().numpy()
    for r in bad[:8].tolist():
        o, d = o3[:, r].cpu().numpy(), d3u[:, r].cpu().numpy()
        margins = [None if i < 0 else bary_margin_f64(pack, o, d, i)
                   for i in (int(idx[r]), int(want_idx[r]))]
        log(f"[2] {what}: lane {r} o {o.tolist()} d {d.tolist()}: kernel "
            f"{int(idx[r])} at t {float(t[r])!r}, model {int(want_idx[r])} at "
            f"t {float(want_t[r])!r}; barycentric margins {margins}")
    fail(f"{what}: winners or t differ from the culled model on {len(bad)} "
         f"of {idx.numel()} lanes")


def hold_same_triangles(what, packs, pair, o3, d3u, t, idx, ref) -> int:
    """The winners of another pack of the same triangles. ``packs``: this
    sweep's ([T, 12] pack, pack in the layout of ``pair``); ``ref`` = (t,
    idx, [T, 12] pack, pack) of the scene-order sweep of the same rays. t
    equal on every lane; the rows named equal in their vertices, but where
    both named triangles are hit at that very t (a ray through an edge two
    triangles share: each pack's smallest index wins). Returns the number
    of such tie lanes."""
    tripack, pack = packs
    ref_t, ref_idx, ref_tripack, ref_pack = ref
    diff = (t - ref_t).abs().max().item()
    if diff != 0.0 or not torch.equal(idx < 0, ref_idx < 0):
        fail(f"{what}: t differs from the scene-order pack's (max abs diff "
             f"{diff})")
    rows = tripack[idx.clamp_min(0).long(), 0:9]
    ref_rows = ref_tripack[ref_idx.clamp_min(0).long(), 0:9]
    other = torch.nonzero((idx >= 0) & (rows != ref_rows).any(dim=1))
    for r in other.flatten().tolist():
        rays = [o3[k:k + 1, r:r + 1] for k in range(3)] + [
            d3u[k:k + 1, r:r + 1] for k in range(3)]
        both = torch.stack([pack[int(idx[r])], ref_pack[int(ref_idx[r])]])
        h, tt = pair.rows(both, *rays)
        if not (bool(h.all()) and bool((tt == t[r]).all())):
            fail(f"{what}: lane {r} names row {int(idx[r])}, not the "
                 f"triangle of scene-order row {int(ref_idx[r])}")
    return len(other)


def sides_agree(o3, d3u, pack36, cull, t, idx, tested: int) -> dict:
    """The pairs of a render wavefront on which a sign-first Plücker sweep
    (P1's) would compute the plane: those whose three sides agree, among
    the pairs whose tile and group boxes a lane meets up to its winner's t
    (``pairs_met``, a subset of the ``tested`` pairs of the culled sweep,
    whose running best never falls below the winner's t), and among all
    pairs. ``inside_share_tested``: the least and the most share of the
    tested pairs that can have sides of one sign, all of the tested pairs
    outside ``pairs_met`` counted as outside and as inside."""
    from pathtracerpython_tpu_torch.kernels import intersect
    from pathtracerpython_tpu_torch.probes import mma_probe

    reach = torch.where(idx >= 0, t, intersect.BIG)
    met, inside_met = mma_probe.inside_pairs(o3, d3u, pack36, cull, reach)
    if met > tested:
        fail(f"{met} pairs met up to the winners, {tested} tested")
    every, inside_all = mma_probe.inside_pairs(o3, d3u, pack36)
    share = (inside_met / max(tested, 1),
             (inside_met + tested - met) / max(tested, 1))
    return {"pairs_met": met, "inside_met": inside_met,
            "pairs_every": every, "inside_all": inside_all,
            "inside_share_tested": share}


def nearest_bounds(tripack, o3, d3u, t, idx, nbytes, flops) -> dict:
    """The bound of a culled nearest sweep whose winners are (t, idx): per
    lane the valid rows whose own grown box its ray meets up to its
    winner's t (the whole ray for a lane that misses), the bound stretched
    as the kernels stretch it. The lane's running best never falls below
    its winner's t, and a group box holds its rows' own boxes, so a kernel
    cannot test fewer. Beside it the earlier reckoning, every valid row for
    every lane, as ``all_pairs_bound_ms``."""
    from pathtracerpython_tpu_torch.kernels import intersect

    reach = torch.where(idx >= 0, t, intersect.BIG)
    needed = int(own_box_counts(tripack, o3, d3u, reach, mask_col=None).sum())
    every = o3.shape[1] * int((tripack[:, 9] > 0.5).sum())
    return {"bound": bound(nbytes, needed, flops), "pairs_needed": needed,
            "pairs_all": every,
            "all_pairs_bound_ms": bound(nbytes, every, flops)[0]}


def check_nearest(form, label, scene, o3, d3u, report, classic=None,
                  reference=None):
    """K1 (``form`` "classic") or K3's dense nearest ("plucker") on one
    wavefront. The kernel against the culled plain model on the card:
    winners and t equal on every lane. Against the un-culled plain version
    under K1's bounds, with the number of lanes that differ (or, with
    ``reference`` = (t, idx, [T, 12] pack, pack) of the scene-order sweep
    of the same triangles, against those: ``hold_same_triangles``). The
    counting instance gives the same winners and counts what it culled;
    the bound is ``nearest_bounds``. ``classic``: K1's (t, idx, ms) of the
    same rays, which K3's are held against under the forms' contract.
    Returns ((t, idx, ms), the reference of another pack's sweep)."""
    from pathtracerpython_tpu_torch.kernels import intersect

    plucker = form == "plucker"
    name = "K3 nearest" if plucker else "K1"
    tripack = intersect.scene_tripack(scene)
    pack = intersect.scene_plucker_pack(scene) if plucker else tripack
    pair = intersect.PLUCKER if plucker else intersect.CLASSIC
    launch = intersect._launch_plucker if plucker else intersect._launch
    cull = intersect.nearest_cull_boxes(tripack)
    run = lambda: intersect.nearest_t_idx_cm(o3, d3u, scene, mt_impl=form)
    t_k, i_k = run()
    tested = []
    t_m, i_m = intersect.nearest_t_idx_plain(o3, d3u, pack, pair, cull,
                                             tested)
    hold_winners(f"{name} {label}", tripack, o3, d3u, t_k, i_k, t_m, i_m)
    if reference is None:
        (t_p, i_p), p_ms = once_ms(lambda: intersect.nearest_t_idx_plain(
            o3, d3u, pack, pair))
        agree, grazing, err = check_winners(
            f"{name} {label} against the un-culled plain version", tripack,
            o3, d3u, t_k, i_k, t_p, i_p)
        against = (f"against the un-culled plain version winners "
                   f"{agree:.6f} ({int((i_k != i_p).sum())} lanes differ, "
                   f"{grazing} grazing), t max abs err {err:.3g}")
    else:
        p_ms, err = None, 0.0
        ties = hold_same_triangles(f"{name} {label}", (tripack, pack), pair,
                                   o3, d3u, t_k, i_k, reference)
        against = (f"t equal to the scene-order pack's on every lane, the "
                   f"same triangles but on {ties} lanes through a shared "
                   "edge")
    more = {}
    if plucker and reference is None:
        more = sides_agree(o3, d3u, pack, cull, t_m, i_m, tested[0])
        against += (f"; sides of one sign on {more['inside_met']} of the "
                    f"{more['pairs_met']} pairs met up to the winner, so on "
                    f"{more['inside_share_tested'][0]:.4f}-"
                    f"{more['inside_share_tested'][1]:.4f} of the "
                    f"{tested[0]} tested, and on {more['inside_all']} of all "
                    f"{more['pairs_every']} "
                    f"({more['inside_all'] / more['pairs_every']:.5f})")
    if classic is not None:
        t_c, i_c, c_ms = classic
        agree_c, grazing_c, err_c = check_winners(
            f"K3 nearest {label} against K1", tripack, o3, d3u, t_k, i_k,
            t_c, i_c, min_agree=FORM_MIN_AGREE, margin=FORM_MARGIN,
            t_tol=FORM_T_TOL)
        more.update(classic_ms=c_ms, classic_agree=agree_c)
        against += (f"; against K1 winners {agree_c:.6f} ({grazing_c} "
                    f"grazing), t max abs diff {err_c:.3g}")
    k_ms = cuda_ms(run, 10)
    extras, (t_c2, i_c2) = count_culled(
        lambda cull_, stats: launch(o3, d3u, pack, cull_, stats), tripack,
        o3.shape[1], cull)
    hold_winners(f"{name} {label}, counting instance", tripack, o3, d3u,
                 t_c2, i_c2, t_m, i_m)
    if extras["pairs_tested"] != tested[0]:
        log(f"[2] {name} {label}: the counting instance tested "
            f"{extras['pairs_tested']} pairs, the culled model {tested[0]}")
    bounds = nearest_bounds(
        tripack, o3, d3u, t_m, i_m, tensor_bytes(o3, d3u, pack, t_k, i_k),
        FLOPS_PER_PAIR_PLUCKER if plucker else FLOPS_PER_PAIR_TILE)
    row = culled_row(name, label, err, k_ms, p_ms, bounds, extras,
                     model_pairs=tested[0], **more)
    valid = int((tripack[:, 9] > 0.5).sum())
    log(f"[2] {name} {label}: {o3.shape[1]} lanes x {valid} rows, hit "
        f"{(i_k >= 0).float().mean().item():.4f}, equal to the culled model "
        f"on every lane (max abs diff 0); {against}; kernel {k_ms:.3f} ms, "
        + ("" if classic is None else f"K1 {classic[2]:.3f} ms, ")
        + ("" if p_ms is None else f"plain {p_ms:.3f} ms; ")
        + culled_text(row))
    report.append(row)
    return (t_k, i_k, k_ms), (t_k, i_k, tripack, pack)


def check_large_dense(label, scene, o3, d3u, r_blk, report):
    """Dense K1, culled, on one wavefront of the 100k field, where it is the
    whole-wavefront reference of K5 and K8: against the un-culled plain
    version on every SUBSET_STRIDE-th ray block of ``r_blk`` lanes, its
    counting instance on that subset against the whole wavefront's winners,
    timed on all lanes and on the subset, with the subset's bound. Returns
    (t, idx, ms on all lanes)."""
    from pathtracerpython_tpu_torch.kernels import intersect

    tripack = intersect.scene_tripack(scene)
    cull = intersect.scene_nearest_cull_boxes(scene)
    run = lambda: intersect.nearest_t_idx_cm(o3, d3u, scene)
    t_k, i_k = run()
    n = o3.shape[1]
    blocks = torch.arange(0, -(-n // r_blk), SUBSET_STRIDE, device=o3.device)
    lanes = (blocks[:, None] * r_blk
             + torch.arange(r_blk, device=o3.device)[None, :]).flatten()
    lanes = lanes[lanes < n]
    o_s, d_s = o3[:, lanes].contiguous(), d3u[:, lanes].contiguous()
    (t_p, i_p), p_ms = once_ms(lambda: intersect.nearest_t_idx_plain(
        o_s, d_s, tripack))
    agree, grazing, err = check_winners(
        f"K1 {label} against the un-culled plain version", tripack, o_s, d_s,
        t_k[lanes], i_k[lanes], t_p, i_p)
    ka_ms = cuda_ms(run, 10)
    ks_ms = cuda_ms(lambda: intersect._launch(o_s, d_s, tripack, cull), 10)
    extras, (t_c, i_c) = count_culled(
        lambda cull_, stats: intersect._launch(o_s, d_s, tripack, cull_,
                                               stats),
        tripack, o_s.shape[1], cull)
    hold_winners(f"K1 {label}, counting instance on the subset", tripack,
                 o_s, d_s, t_c, i_c, t_k[lanes], i_k[lanes])
    bounds = nearest_bounds(tripack, o_s, d_s, t_c, i_c,
                            tensor_bytes(o_s, d_s, tripack, t_c, i_c),
                            FLOPS_PER_PAIR_TILE)
    row = culled_row("K1", label, err, ks_ms, p_ms, bounds, extras,
                     kernel_all_ms=ka_ms, subset_lanes=o_s.shape[1])
    valid = int((tripack[:, 9] > 0.5).sum())
    log(f"[2] K1 {label}: {n} lanes x {valid} rows, hit "
        f"{(i_k >= 0).float().mean().item():.4f}; on {o_s.shape[1]} lanes "
        f"(every {SUBSET_STRIDE}th block of {r_blk}) against the un-culled "
        f"plain version winners {agree:.6f} ({int((i_k[lanes] != i_p).sum())}"
        f" lanes differ, {grazing} grazing), t max abs err {err:.3g}; kernel "
        f"on all lanes {ka_ms:.3f} ms; on the subset kernel {ks_ms:.3f} ms, "
        f"plain {p_ms:.3f} ms; " + culled_text(row))
    report.append(row)
    return t_k, i_k, ka_ms


def check_form_bits(what, scene, o3, d3, maxd, occ, classic) -> float:
    """K3's any-hit bits against its classic twin's: equal on
    FORM_MIN_AGREE of lanes (the population bound of the JAX package's
    tests/test_plucker.py). Of up to 64 lanes that differ it reports how
    many have an occluder whose verdict is within FORM_MARGIN of flipping
    in float64 by the edge and window measure; a ray that runs in a
    triangle's plane, where both forms divide rounding noise by rounding
    noise, is not caught by that measure. Returns the share of equal
    bits."""
    same = occ == classic
    agree = same.float().mean().item()
    if agree < FORM_MIN_AGREE:
        fail(f"{what}: bits agree with the classic form on {agree:.6f} of "
             "lanes")
    bad = torch.nonzero(~same).flatten()
    near_edge = 0
    if len(bad):
        tri = [x[scene.tri_occluder].double() for x in (
            scene.tri_v0, scene.tri_v1, scene.tri_v2)]
        v0, e1, e2 = tri[0], tri[1] - tri[0], tri[2] - tri[0]
        for r in bad[:64].tolist():
            o, d = o3[:, r].double(), d3[:, r].double()
            pv = torch.linalg.cross(d.expand_as(e2), e2)
            det = (e1 * pv).sum(dim=1)
            det = torch.where(det.abs() < 1e-300, 1e-300, det)
            tv = o - v0
            qv = torch.linalg.cross(tv, e1)
            u = (tv * pv).sum(dim=1) / det
            v = (qv * d).sum(dim=1) / det
            t = (qv * e2).sum(dim=1) / det
            md = float(maxd[r])
            # how far each occluder is from blocking (> 0) or not (< 0)
            room = torch.stack([u, v, 1.0 - u - v, t - 1e-4,
                                md - 1e-4 - t]).amin(dim=0)
            near_edge += room.abs().min().item() < FORM_MARGIN
    log(f"[2] {what} against the classic form: {len(bad)} of "
        f"{occ.shape[0]} lanes differ; of the first {min(len(bad), 64)}, "
        f"{near_edge} have an occluder within {FORM_MARGIN} of flipping")
    return agree


def own_box_counts(tripack, o3, d3, bound,
                   mask_col=OCCLUDER_COL) -> torch.Tensor:
    """i64[N]: for every lane, the occluder rows (every valid row with
    ``mask_col`` None) whose own box (the kernels' grown box of that one
    row) the lane's segment meets up to ``bound`` under the kernels' slab
    test (the limit stretched as the kernels stretch it). A culled any-hit
    sweep cannot test fewer pairs for a lane that ends unoccluded: its
    groups hold these boxes."""
    from pathtracerpython_tpu_torch.kernels import intersect

    boxes = intersect.grow_boxes(intersect.block_aabbs(tripack, 1, mask_col))
    boxes = boxes[boxes[:, 0] <= boxes[:, 3]]
    bound = bound * intersect.CULL_REACH
    o_rows = [o3[k:k + 1] for k in range(3)]
    d_rows = [d3[k:k + 1] for k in range(3)]
    counts = torch.zeros(o3.shape[1], dtype=torch.int64, device=o3.device)
    step = intersect.chunk_rows(o3.shape[1])
    for lo in range(0, boxes.shape[0], step):
        hit, _ = intersect.aabb_cull_rows(boxes[lo:lo + step], o_rows, d_rows,
                                          bound[None, :])
        counts += hit.sum(dim=0)
    return counts


def sweep_bounds(nbytes, counts, can, occluded, occluders, flops) -> dict:
    """The bound of a culled any-hit sweep over lanes that end ``occluded``
    (bool, flat) or not: an unoccluded lane that ``can`` be occluded needs
    the occluders whose own box it meets (``counts``), an occluded lane
    one. Beside it the earlier reckoning, every occluder for an unoccluded
    lane, as ``all_pairs_bound_ms``."""
    free = can & ~occluded
    needed = int(counts[free].sum()) + int(occluded.sum())
    every = int(free.sum()) * occluders + int(occluded.sum())
    return {"bound": bound(nbytes, needed, flops), "pairs_needed": needed,
            "pairs_all": every,
            "all_pairs_bound_ms": bound(nbytes, every, flops)[0]}


def hold_bits(what, got, want, tripack, o3, d3, limit,
              against="the un-culled plain version") -> float:
    """Occlusion bits ``got`` equal to ``want`` (those of ``against``) on
    every lane (flat, in the order of the rays o3/d3 with their limits);
    else print up to 8 lanes that differ, each with its ray, its limit and
    the first occluder row that the plain pair test says blocks it, and
    fail. Returns the max abs difference of the 0/1 bits, as measured."""
    from pathtracerpython_tpu_torch.kernels import intersect

    diff = got.flatten() != want.flatten()
    bad = torch.nonzero(diff).flatten()
    if not len(bad):
        return diff.float().max().item()
    occluders = torch.nonzero(tripack[:, 10] > 0.5).flatten()
    for r in bad[:8].tolist():
        rays = [o3[k:k + 1, r:r + 1] for k in range(3)] + [
            d3[k:k + 1, r:r + 1] for k in range(3)]
        hit, t = intersect.mt_rows(tripack[occluders], *rays)
        blocks = torch.nonzero((hit & (t < limit[r] - intersect.T_MIN))[:, 0])
        row = int(occluders[blocks[0, 0]]) if len(blocks) else None
        log(f"[2] {what}: lane {r} kernel {bool(got.flatten()[r])} plain "
            f"{bool(want.flatten()[r])}; o {o3[:, r].tolist()} d "
            f"{d3[:, r].tolist()} limit {float(limit[r])!r}; blocked by row "
            f"{row}" + ("" if row is None else
                        f" {tripack[row, :9].tolist()} at t "
                        f"{float(t[blocks[0, 0], 0])!r}"))
    fail(f"{what}: occlusion bits differ from {against} on {len(bad)} of "
         f"{got.numel()} lanes")


def count_culled(launch, tripack, n, boxes) -> tuple:
    """What a culled kernel's counting instance counts. ``launch(cull,
    stats)`` runs the kernel over ``n`` lanes with ``boxes``. Returns (the
    row's extras, the counting instance's output)."""
    from pathtracerpython_tpu_torch.kernels import intersect

    stats = torch.zeros(3, dtype=torch.int64, device=tripack.device)
    counted = launch(boxes, stats)
    torch.cuda.synchronize()
    return {"g": intersect.CULL_GROUP,
            **intersect.cull_stats(stats, n, tripack.shape[0])}, counted


def culled_row(what, label, err, k_ms, p_ms, bounds, extras, **more) -> dict:
    """The report row of the culled sweep ``what`` on the wavefront
    ``label``; fails if the kernel reads under its bound."""
    b = bounds["bound"]
    if k_ms < b[0]:
        fail(f"{what} {label}: kernel {k_ms} ms reads under its bound "
             f"{b[0]} ms")
    return report_row(label, err, k_ms, p_ms, b, over_bound=k_ms / b[0],
                      **{k: v for k, v in bounds.items() if k != "bound"},
                      **extras, **more)


def culled_text(row) -> str:
    """What a culled sweep's row says of the cull, for the log."""
    return (f"groups of {row['g']} rows; tested {row['pairs_tested']} pairs "
            f"of {row['pairs_all']} ({row['pairs_needed']} needed), skipped "
            f"{row['tiles_skipped']:.4f} of tiles and "
            f"{row['groups_skipped']:.4f} of groups; bound "
            f"{row['bound_ms']:.4f} ms by {row['bound_by']} (kernel "
            f"{row['over_bound']:.1f}x), all-pairs bound "
            f"{row['all_pairs_bound_ms']:.4f} ms")


def check_k2(label, scene, point3, normal3, u, shadow, counts, report,
             reference=None):
    """K2 on one wavefront against its un-culled plain version (or, with
    ``reference`` = (mean cosine, bits) of another pack of the same
    triangles, against that): bits equal on every lane-sample, mean cosine
    within MC_ATOL. ``shadow`` and ``counts``: the same samples as shadow
    rays, and their ``own_box_counts``. Returns (mean cosine, bits)."""
    from pathtracerpython_tpu_torch.kernels import intersect, nee

    tripack = intersect.scene_tripack(scene)
    lightpack = nee.light_pack(scene)
    run = lambda: nee.nee_mean_cos_fused(point3, normal3, u, scene,
                                         NEE_SAMPLES)
    mc_k, occ_k = run()
    if reference is None:
        (mc_p, occ_p), p_ms = once_ms(lambda: nee.nee_mean_cos_plain(
            point3, normal3, u, tripack, lightpack, NEE_SAMPLES))
    else:
        (mc_p, occ_p), p_ms = reference, None
    sh = [x.contiguous() for x in (shadow.o3, shadow.d3, shadow.maxd)]
    hold_bits(f"K2 {label}", occ_k > 0.5, occ_p > 0.5, tripack, *sh)
    err = (mc_k - mc_p).abs().max().item()
    if err > MC_ATOL:
        fail(f"K2 {label}: mean cosine max abs err {err} > {MC_ATOL}")
    k_ms = cuda_ms(run, 10)
    extras, (_, occ_c) = count_culled(
        lambda cull, stats: nee._launch(point3, normal3, u, tripack,
                                        lightpack, NEE_SAMPLES, cull, stats),
        tripack, point3.shape[1], intersect.cull_boxes(tripack))
    hold_bits(f"K2 {label}, counting instance", occ_c > 0.5, occ_p > 0.5,
              tripack, *sh)
    occluders = int((tripack[:, 10] > 0.5).sum())
    blocked = (occ_p > 0.5).flatten()
    bounds = sweep_bounds(
        tensor_bytes(point3, normal3, u, tripack, lightpack, mc_k, occ_k),
        counts, torch.ones_like(blocked), blocked, occluders,
        FLOPS_PER_PAIR_TILE)
    row = culled_row("K2", label, err, k_ms, p_ms, bounds, extras)
    log(f"[2] K2 {label}: {point3.shape[1]} lanes x {NEE_SAMPLES} samples x "
        f"{occluders} occluders, occlusion equal on every lane-sample (max "
        f"abs diff 0), mean cos max abs err {err:.3g}; kernel {k_ms:.3f} ms, "
        + ("bits of the scene-order pack; " if p_ms is None
           else f"plain {p_ms:.3f} ms; ") + culled_text(row))
    report.append(row)
    return mc_k, occ_k


def check_bits(what, occ, want) -> tuple[float, float]:
    """Occlusion bits equal on MIN_OCC_AGREE of lanes. Returns (share of
    equal bits, max abs difference of the 0/1 bits)."""
    agree = (occ == want).float().mean().item()
    if agree < MIN_OCC_AGREE:
        fail(f"{what}: occlusion agrees on {agree:.6f} of lanes")
    return agree, (occ.float() - want.float()).abs().max().item()


def once_ms(fn):
    """(result, milliseconds) of one run of ``fn()`` by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def check_dense_any_hit(form, label, scene, shadow, counts, report,
                        classic=None, reference=None):
    """K4 (``form`` "classic") or K3's dense any-hit ("plucker") on one
    wavefront of shadow rays against its un-culled plain version (or, with
    ``reference`` = the bits of another pack of the same triangles, against
    those): bits equal on every lane. ``counts``: the lanes'
    ``own_box_counts``. ``classic``: K4's (bits, ms) of the same rays, which
    K3's are held against under the forms' contract. Returns (bits, ms)."""
    from pathtracerpython_tpu_torch.kernels import intersect

    plucker = form == "plucker"
    name = "K3 any-hit" if plucker else "K4"
    tripack = intersect.scene_tripack(scene)
    pack = intersect.scene_plucker_pack(scene) if plucker else tripack
    pair = intersect.PLUCKER if plucker else intersect.CLASSIC
    launch = (intersect._launch_plucker_any_hit if plucker
              else intersect._launch_any_hit)
    o3, d3, maxd = (x.contiguous() for x in (shadow.o3, shadow.d3,
                                              shadow.maxd))
    run = lambda: intersect.any_hit_cm(o3, d3, maxd, scene, mt_impl=form)
    occ = run()
    if reference is None:
        plain, p_ms = once_ms(lambda: intersect.any_hit_plain(
            o3, d3, maxd, pack, pair))
    else:
        plain, p_ms = reference, None
    hold_bits(f"{name} {label}", occ, plain, tripack, o3, d3, maxd)
    err = (occ != plain).float().max().item()
    more = {}
    if classic is not None:
        more = dict(classic_ms=classic[1], classic_agree=check_form_bits(
            f"K3 any-hit {label}", scene, o3, d3, maxd, occ, classic[0]))
    k_ms = cuda_ms(run, 10)
    extras, counted = count_culled(
        lambda cull, stats: launch(o3, d3, maxd, pack, cull, stats), tripack,
        o3.shape[1], intersect.cull_boxes(tripack))
    hold_bits(f"{name} {label}, counting instance", counted, plain, tripack,
              o3, d3, maxd)
    occluders = int((tripack[:, 10] > 0.5).sum())
    bounds = sweep_bounds(
        tensor_bytes(o3, d3, maxd, pack, occ), counts,
        maxd - intersect.T_MIN > intersect.T_MIN, plain, occluders,
        FLOPS_PER_PAIR_PLUCKER if plucker else FLOPS_PER_PAIR_TILE)
    row = culled_row(name, label, err, k_ms, p_ms, bounds, extras, **more)
    log(f"[2] {name} {label}: {o3.shape[1]} shadow lanes x {occluders} "
        f"occluders, occluded {occ.float().mean().item():.4f}, equal to "
        + ("the scene-order pack's bits" if p_ms is None
           else "the un-culled plain version")
        + f" on every lane (max abs diff {err:g}); kernel {k_ms:.3f} ms, "
        + ("" if classic is None else f"K4 {classic[1]:.3f} ms, ")
        + ("" if p_ms is None else f"plain {p_ms:.3f} ms; ")
        + culled_text(row))
    report.append(row)
    return occ, k_ms


def block_subset(o3_rows, lists, r_blk, stride, blocks=None):
    """Every ``stride``-th ray block of a wavefront (or the blocks of the
    index tensor ``blocks``): the rows [..., lanes] of its lanes and its
    lists (a block's list concerns its own lanes only, so the subset is a
    wavefront of its own)."""
    from pathtracerpython_tpu_torch.kernels.sparse import BlockLists

    n = o3_rows[0].shape[-1]
    if blocks is None:
        blocks = torch.arange(0, lists.ncand.shape[0], stride,
                              device=lists.ncand.device)
    lanes = (blocks[:, None] * r_blk
             + torch.arange(r_blk, device=blocks.device)[None, :]).flatten()
    lanes = lanes[lanes < n]
    rows = [x[..., lanes].contiguous() for x in o3_rows]
    return lanes, rows, BlockLists(*(x[blocks].contiguous() for x in lists))


def tail_causes(o3, d3u, idx, lists, r_blk) -> dict:
    """What makes a block's walk long, counted over a wavefront's blocks and
    over the 1% of blocks with the longest lists: a live lane that misses
    (its bound stays BIG, so no stop ever passes it), live lanes in more
    than one direction octant (the block's direction box crosses an axis:
    its entry bound is -BIG there, so its list holds much of the scene with
    bound 0), and parked lanes beside live ones (the park edge: the origin
    box reaches PARK_ORIGIN)."""
    from pathtracerpython_tpu_torch.kernels import sparse
    from pathtracerpython_tpu_torch.ops.sort import PARK_ORIGIN

    nrb = lists.ncand.shape[0]
    cut = lambda x: sparse.pad_repeat_last(x, r_blk).reshape(nrb, r_blk)
    live = o3[1] != PARK_ORIGIN[1]
    octant = ((d3u > 0).long()
              * torch.tensor([[1], [2], [4]], device=d3u.device)).sum(dim=0)
    oct_b = cut(torch.where(live, octant, -1))
    causes = {
        "a missing live lane": cut(live & (idx < 0)).any(dim=1),
        "two octants": ((oct_b.amax(dim=1) >= 0)
                        & (torch.where(oct_b >= 0, oct_b, 8).amin(dim=1)
                           != oct_b.amax(dim=1))),
        "the park edge": cut(~live).any(dim=1) & cut(live).any(dim=1),
    }
    longest = lists.ncand > torch.quantile(lists.ncand.float(), 0.99)
    return {"blocks": nrb, "longest_list": int(lists.ncand.max()),
            "blocks_over_one_segment": int(
                (lists.ncand > sparse.WALK_SEGMENT).sum()),
            "blocks_with": {k: int(v.sum()) for k, v in causes.items()},
            "longest_1pct_blocks": int(longest.sum()),
            "longest_1pct_with": {k: int((v & longest).sum())
                                  for k, v in causes.items()}}


def check_nearest_walk(name, label, scene, o3, d3u, stride, report, dense,
                       *, r_blk, wrapper, launch, plain, others=(),
                       pack=None, dense_name="K1",
                       flops=FLOPS_PER_PAIR_ROW):
    """A cluster walk's nearest sweep (K5, K8 or K3's) on one wavefront:
    against its plain version on every ``stride``-th ray block, against the
    dense sweep ``dense_name`` (``dense``: its (t, idx, ms)) and against
    ``others`` [(name, t, idx)] on all lanes. ``pack``: the Plücker pack
    that ``launch`` and ``plain`` read, when it is not the [T, 12] one. The
    split walk's counting instance on the same blocks: its winners the
    timed instance's, its units those the lists give, its visits inside
    their band (``walk_visit_band``) beside the serial walk's; on all
    blocks the units launched and stopped at once, and ``tail_causes``.
    Returns the sweep's (t, idx)."""
    from pathtracerpython_tpu_torch.kernels import intersect, sparse

    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    rows_pack = tripack if pack is None else pack
    n = o3.shape[1]
    nrb = -(-n // r_blk)
    make_lists = lambda: sparse.block_lists(aabb8, o3, d3u, torch.full(
        (nrb,), intersect.BIG, device=o3.device), r_blk)
    lists = make_lists()
    t_k, i_k = wrapper(o3, d3u, scene)
    lanes, (o_s, d_s), sub = block_subset([o3, d3u], lists, r_blk, stride)
    visits = []
    (t_p, i_p), p_ms = once_ms(lambda: plain(o_s, d_s, rows_pack, aabb8, sub,
                                             r_blk, visits))
    agree_p, grazing_p, err = check_winners(
        f"{name} {label} against plain", tripack, o_s, d_s, t_k[lanes],
        i_k[lanes], t_p, i_p)
    t_d, i_d, d_ms = dense
    agree_d, grazing_d, err_d = check_winners(
        f"{name} {label} against {dense_name}", tripack, o3, d3u, t_k, i_k,
        t_d, i_d)
    for other, t_o, i_o in others:
        check_winners(f"{name} {label} against {other}", tripack, o3, d3u,
                      t_k, i_k, t_o, i_o)
    k_ms = cuda_ms(lambda: wrapper(o3, d3u, scene), 10)
    ks_ms = cuda_ms(lambda: launch(o_s, d_s, rows_pack, aabb8, sub, r_blk),
                    10)
    ka_ms = ks_ms if stride == 1 else cuda_ms(
        lambda: launch(o3, d3u, rows_pack, aabb8, lists, r_blk), 10)
    lists_ms = cuda_ms(make_lists, 10)
    # the tail: the same launch without the 1% of blocks with the longest
    # lists (a kernel is as slow as its slowest CTA)
    cut = torch.quantile(lists.ncand.float(), 0.99)
    short = torch.nonzero(lists.ncand <= cut).flatten()
    _, (o_q, d_q), sub_q = block_subset([o3, d3u], lists, r_blk, 1, short)
    kq_ms = cuda_ms(lambda: launch(o_q, d_q, rows_pack, aabb8, sub_q, r_blk),
                    10)
    serial_visits = int(torch.stack(visits).sum())
    pairs = serial_visits * C_TRI
    b = bound(tensor_bytes(o_s, d_s, rows_pack, aabb8, *sub, t_p, i_p), pairs,
              flops)
    # the counting instance on the subset, then on all blocks
    stats = torch.zeros(3, dtype=torch.int64, device=o3.device)
    t_c, i_c = launch(o_s, d_s, rows_pack, aabb8, sub, r_blk, stats)
    if not (torch.equal(i_c, i_k[lanes]) and torch.equal(t_c, t_k[lanes])):
        fail(f"{name} {label}: the counting instance's winners differ")
    counted = sparse.walk_stats(stats)
    pair = intersect.CLASSIC if pack is None else intersect.PLUCKER
    floor, ceiling = sparse.walk_visit_band(o_s, d_s, rows_pack, aabb8, sub,
                                            r_blk, t_p, i_p,
                                            sparse.WALK_SEGMENT, pair)
    if counted["units_launched"] != sparse.walk_units(sub, r_blk):
        fail(f"{name} {label}: {counted['units_launched']} units launched, "
             f"the lists give {sparse.walk_units(sub, r_blk)}")
    if not floor <= counted["visits"] <= ceiling:
        fail(f"{name} {label}: {counted['visits']} visits outside their band "
             f"[{floor}, {ceiling}]")
    stats.zero_()
    launch(o3, d3u, rows_pack, aabb8, lists, r_blk, stats)
    counted_all = sparse.walk_stats(stats)
    causes = tail_causes(o3, d3u, i_k, lists, r_blk)
    nc = lists.ncand.float()
    log(f"[2] {name} {label}: {n} lanes in {nrb} blocks of {r_blk}, "
        f"{aabb8.shape[0]} clusters, candidates per block mean "
        f"{nc.mean().item():.1f} max {int(nc.max().item())}, hit "
        f"{(i_k >= 0).float().mean().item():.4f}; against plain on "
        f"{sub.ncand.shape[0]} of {nrb} blocks ({o_s.shape[1]} lanes): "
        f"winners {agree_p:.6f} ({grazing_p} grazing), t max abs err "
        f"{err:.3g}; against {dense_name}"
        f"{''.join(' and ' + o[0] for o in others)} on all lanes: winners "
        f"{agree_d:.6f} ({grazing_d} grazing), t max abs err {err_d:.3g}")
    log(f"[2] {name} {label} times: wrapper (lists + kernel) {k_ms:.3f} ms, "
        f"lists {lists_ms:.3f} ms, kernel on all blocks {ka_ms:.3f} ms, on "
        f"the {short.shape[0]} blocks with lists of at most {int(cut)} "
        f"clusters (99%) {kq_ms:.3f} ms; on the subset kernel {ks_ms:.3f} "
        f"ms, "
        f"plain {p_ms:.3f} ms, bound {b[0]:.4f} ms by {b[1]} ({pairs} pairs "
        f"through the per-ray gate); dense {dense_name} on all lanes "
        f"{d_ms:.3f} ms")
    log(f"[2] {name} {label} split walk (units of {sparse.WALK_SEGMENT} "
        f"slots): on the subset {counted['units_launched']} units, "
        f"{counted['units_stopped_at_once']} stopped at once, visits "
        f"{counted['visits']} (serial walk {serial_visits}, band [{floor}, "
        f"{ceiling}]); on all blocks {counted_all['units_launched']} units, "
        f"{counted_all['units_stopped_at_once']} stopped at once, visits "
        f"{counted_all['visits']}; blocks {json.dumps(causes)}")
    report.append(report_row(label, max(err, err_d), ks_ms, p_ms, b,
                             wrapper_ms=k_ms, kernel_all_ms=ka_ms,
                             kernel_short99_ms=kq_ms, lists_ms=lists_ms,
                             dense_ms=d_ms, visits=counted["visits"],
                             serial_visits=serial_visits,
                             visits_floor=floor, visits_ceiling=ceiling,
                             units=counted_all["units_launched"],
                             units_stopped_at_once=counted_all[
                                 "units_stopped_at_once"],
                             visits_all=counted_all["visits"], **causes))
    return t_k, i_k


def walk_bound(rays, outputs, lists, pack, needed, gate_pairs, flops):
    """The bound of a split any-hit walk over ``lists``: the bytes (the
    rays, its ``outputs``, and ``list_bytes`` of the lists over ``pack``)
    or the ``needed`` pairs times ``flops``, whichever takes longer; and
    beside it the bound of the gate's pairs (C_TRI a visit of the serial
    walk), the one before the in-cluster cull."""
    nbytes = tensor_bytes(*rays, *outputs) + list_bytes(lists, pack)
    return bound(nbytes, needed, flops), bound(nbytes, gate_pairs, flops)[0]


def split_walk_extras(what, launch, rays, lists, r_blk, want, tripack, pack,
                      aabb8, cull, pair) -> dict:
    """What a split any-hit walk (K6, K9, K3's sparse any-hit or K7) shows
    beyond its outputs, on the wavefront ``rays`` (o3, d3, maxd) and its
    ``lists``. ``launch(rays, lists, stats=None)`` runs it and returns its
    outputs as a tuple (the bits, then K7's clusters); ``want`` is that
    tuple on all lanes; ``pack`` the rows it reads. The tail: the launch
    without the 1% of blocks with the longest lists (a kernel is as slow as
    its slowest unit). The counting instance on every SUBSET_STRIDE-th
    block (the band's ceiling walks every segment from nothing): its
    outputs ``want``'s, its units those the lists give, its visits, box
    tests and pairs inside ``any_hit_visit_band``, its pairs at most C_TRI
    a visit; then its counts on all blocks. Returns these, with "err" the
    largest difference of the outputs it compared."""
    from pathtracerpython_tpu_torch.kernels import sparse

    cut = torch.quantile(lists.ncand.float(), 0.99)
    short = torch.nonzero(lists.ncand <= cut).flatten()
    _, rays_q, sub_q = block_subset(list(rays), lists, r_blk, 1, short)
    kq_ms = cuda_ms(lambda: launch(rays_q, sub_q), 10)
    lanes, rays_b, sub_b = block_subset(list(rays), lists, r_blk,
                                        SUBSET_STRIDE)
    stats = torch.zeros(len(sparse.ANY_HIT_COUNTS), dtype=torch.int64,
                        device=rays[0].device)
    got = launch(rays_b, sub_b, stats)
    err = hold_bits(f"{what}, counting instance", got[0], want[0][lanes],
                    tripack, *rays_b, against="the kernel")
    for g, w in zip(got[1:], want[1:]):
        bad = int((g != w[lanes]).sum())
        if bad:
            fail(f"{what}: the counting instance's blocking clusters differ "
                 f"from the kernel's on {bad} lanes")
    counted = sparse.any_hit_stats(stats)
    band = sparse.any_hit_visit_band(*rays_b, pack, aabb8, sub_b, r_blk,
                                     got[0], sparse.ANY_HIT_SEGMENT, pair,
                                     cull)
    units = sparse.walk_units(sub_b, r_blk, sparse.ANY_HIT_SEGMENT)
    if counted["units_launched"] != units:
        fail(f"{what}: {counted['units_launched']} units launched, the lists "
             f"give {units}")
    for key, (low, high) in band.items():
        if not low <= counted[key] <= high:
            fail(f"{what}: {key} {counted[key]} outside their band [{low}, "
                 f"{high}]")
    if counted["pairs_tested"] > C_TRI * counted["visits"]:
        fail(f"{what}: {counted['pairs_tested']} pairs tested in "
             f"{counted['visits']} visits")
    stats.zero_()
    launch(rays, lists, stats)
    return {"err": err, "kernel_short99_ms": kq_ms,
            "short_blocks": short.shape[0], "cut": int(cut),
            "counted_subset": counted, "band": band,
            "counted_all": sparse.any_hit_stats(stats)}


def extras_text(what, x) -> str:
    """The log lines of ``split_walk_extras``' counts."""
    from pathtracerpython_tpu_torch.kernels import sparse

    return (f"[2] {what} split walk (units of {sparse.ANY_HIT_SEGMENT} "
            f"slots) on every {SUBSET_STRIDE}th block: "
            f"{json.dumps(x['counted_subset'])}, band "
            f"{json.dumps(x['band'])}; on all blocks "
            f"{json.dumps(x['counted_all'])}")


def extras_row(x) -> dict:
    """The report row's keys of ``split_walk_extras``' counts."""
    counted_all = x["counted_all"]
    return {"kernel_short99_ms": x["kernel_short99_ms"],
            "units": counted_all["units_launched"],
            "units_stopped_at_once": counted_all["units_stopped_at_once"],
            **{k: counted_all[k] for k in ("visits", "span_tests",
                                           "mid_tests", "group_tests",
                                           "pairs_tested")},
            "counted_subset": x["counted_subset"],
            "band": {k: list(v) for k, v in x["band"].items()}}


def check_any_hit_walk(name, label, scene, shadow, stride, report, dense,
                       *, r_blk, wrapper, launch, others=(), pack=None,
                       dense_name="K4", flops=FLOPS_PER_PAIR_ROW):
    """A split any-hit walk (K6, K9 or K3's sparse any-hit) on one wavefront
    of shadow rays: against its culled plain model (``any_hit_walk(...,
    cull=)``, the serial walk) on every ``stride``-th ray block, against
    the dense any-hit ``dense_name`` (``dense``: its (bits, ms)) and
    against ``others`` [(name, bits)] on all lanes, bit for bit. ``pack``:
    the Plücker pack that ``launch`` reads, when it is not the [T, 12] one.
    ``split_walk_extras``: the tail and the counting instance. Bound
    (``walk_bound``): the bytes, or the pairs every timing of the units
    must test (each unoccluded lane's culled pairs, one an occluded lane)
    times the form's operations. Returns the sweep's occlusion bits."""
    from pathtracerpython_tpu_torch.kernels import intersect, sparse

    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    rows_pack = tripack if pack is None else pack
    pair = intersect.CLASSIC if pack is None else intersect.PLUCKER
    cull = sparse.scene_cluster_cull_boxes(scene)
    o3, d3, maxd = (x.contiguous() for x in (shadow.o3, shadow.d3,
                                              shadow.maxd))
    n = o3.shape[1]
    lists = sparse.window_lists(aabb8, o3, d3, maxd, r_blk)
    nrb = lists.ncand.shape[0]
    occ = wrapper(o3, d3, maxd, scene)
    lanes, (o_s, d_s, m_s), sub = block_subset([o3, d3, maxd], lists, r_blk,
                                               stride)
    visits, counts = [], {}
    model, p_ms = once_ms(lambda: sparse.any_hit_walk(
        o_s, d_s, m_s, rows_pack, aabb8, sub, r_blk, visits, pair, cull=cull,
        counts=counts)[0])
    err = hold_bits(f"{name} {label}", occ[lanes], model, tripack, o_s,
                    d_s, m_s, against="its culled plain model")
    dense_occ, d_ms = dense
    err = max(err, hold_bits(f"{name} {label} on all lanes", occ, dense_occ,
                             tripack, o3, d3, maxd, against=dense_name))
    for other, occ_o in others:
        err = max(err, hold_bits(f"{name} {label} on all lanes", occ, occ_o,
                                 tripack, o3, d3, maxd, against=other))
    k_ms = cuda_ms(lambda: wrapper(o3, d3, maxd, scene), 10)
    run = lambda rays, lst, stats=None: (launch(
        *rays, rows_pack, aabb8, lst, r_blk, cull, stats),)
    ks_ms = cuda_ms(lambda: run((o_s, d_s, m_s), sub), 10)
    ka_ms = ks_ms if stride == 1 else cuda_ms(
        lambda: run((o3, d3, maxd), lists), 10)
    x = split_walk_extras(f"{name} {label}", run, (o3, d3, maxd), lists,
                          r_blk, (occ,), tripack, rows_pack, aabb8, cull,
                          pair)
    err = max(err, x["err"])
    # the bound, on the checked blocks: the pairs every timing tests
    needed = sparse.any_hit_floor(o_s, d_s, m_s, rows_pack, aabb8, sub,
                                  r_blk, model, pair, cull)["pairs_tested"]
    gate_pairs = counts["visits"] * C_TRI
    b, gate_ms = walk_bound((o_s, d_s, m_s), (model,), sub, rows_pack,
                            needed, gate_pairs, flops)
    if ks_ms < b[0]:
        fail(f"{name} {label}: kernel {ks_ms} ms reads under its bound "
             f"{b[0]} ms")
    parked = (maxd == 0).float().mean().item()
    nc = lists.ncand.float()
    log(f"[2] {name} {label}: {n} shadow lanes ({parked:.4f} parked) in "
        f"{nrb} blocks of {r_blk}, candidates per block "
        f"mean {nc.mean().item():.1f} max {int(nc.max().item())}, occluded "
        f"{occ.float().mean().item():.4f}; equal to its culled plain model "
        f"on {sub.ncand.shape[0]} of {nrb} blocks ({o_s.shape[1]} lanes) and "
        f"to {dense_name}{''.join(', ' + o[0] for o in others)} on all lanes "
        f"(max abs diff 0)")
    log(f"[2] {name} {label} times: wrapper (lists + kernel) {k_ms:.3f} ms, "
        f"kernel on all blocks {ka_ms:.3f} ms, on the {x['short_blocks']} "
        f"blocks with lists of at most {x['cut']} clusters (99%) "
        f"{x['kernel_short99_ms']:.3f} ms; on the checked blocks kernel "
        f"{ks_ms:.3f} ms, plain model {p_ms:.3f} ms, bound {b[0]:.4f} ms by "
        f"{b[1]} ({needed} pairs needed; the serial model tests "
        f"{counts['pairs_tested']}), gate-pairs bound {gate_ms:.4f} ms "
        f"({gate_pairs} pairs through the gate); dense {dense_name} on all "
        f"lanes {d_ms:.3f} ms")
    log(extras_text(f"{name} {label}", x))
    report.append(report_row(
        label, err, ks_ms, p_ms, b, wrapper_ms=k_ms, kernel_all_ms=ka_ms,
        dense_ms=d_ms, over_bound=ks_ms / b[0], pairs_needed=needed,
        gate_pairs=gate_pairs, gate_pairs_bound_ms=gate_ms,
        model_pairs_tested=counts["pairs_tested"],
        model_visits=counts["visits"], **extras_row(x),
        longest_list=int(nc.max().item())))
    return occ


def check_clusters(what, cl, want) -> float:
    """Blocking clusters equal on MIN_CL_AGREE of lanes; returns the
    largest 0/1 mismatch."""
    agree = (cl == want).float().mean().item()
    if agree < MIN_CL_AGREE:
        fail(f"{what}: blocking clusters agree on {agree:.6f} of lanes")
    return (cl != want).float().max().item()


def k7_model(rays, lists, scene, cull) -> dict:
    """K7's culled model (``any_hit_walk(..., cull=, merge="first_slot")``,
    the serial walk) over ``lists`` and its bound (``walk_bound``): the
    bytes, or the pairs every timing of the units tests (each unblocked
    lane's culled pairs, one a blocked lane), whichever takes longer."""
    from pathtracerpython_tpu_torch.kernels import sparse

    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    counts = {}
    (occ, cl), ms = once_ms(lambda: sparse.any_hit_walk(
        *rays, tripack, aabb8, lists, sparse.R_BLK, cull=cull, counts=counts,
        merge="first_slot"))
    needed = sparse.any_hit_floor(*rays, tripack, aabb8, lists, sparse.R_BLK,
                                  occ, cull=cull)["pairs_tested"]
    gate_pairs = counts.get("visits", 0) * C_TRI
    b, gate_ms = walk_bound(rays, (occ, cl), lists, tripack, needed,
                            gate_pairs, FLOPS_PER_PAIR_ROW)
    return {"occ": occ, "cl": cl, "ms": ms, "bound": b,
            "pairs_needed": needed, "gate_pairs": gate_pairs,
            "gate_pairs_bound_ms": gate_ms,
            "model_pairs_tested": counts.get("pairs_tested", 0)}


def hold_k7(what, got, model, tripack, rays, plain) -> float:
    """K7's outputs ``got`` (occ, cl) equal to its culled ``model``'s on
    every lane, and its clusters to the un-culled ``plain`` version's on
    MIN_CL_AGREE of lanes; returns the largest 0/1 mismatch."""
    err = hold_bits(what, got[0], model["occ"], tripack, *rays,
                    against="its culled model")
    bad = int((got[1] != model["cl"]).sum())
    if bad:
        fail(f"{what}: blocking clusters differ from its culled model's on "
             f"{bad} of {got[1].numel()} lanes")
    return max(err, check_clusters(f"{what} against plain", got[1], plain))


def check_k7(label, scene, shadow, carried, occ6, stride, report,
             select_rows) -> None:
    """K7 on one wavefront of shadow rays. On the full lists: the kernel
    against its culled model (``k7_model``) on every ``stride``-th block,
    bits and first blocking clusters equal on every lane, and its clusters
    against the un-culled plain version on MIN_CL_AGREE of lanes; on all
    lanes its bits K6's ``occ6``; ``split_walk_extras``: the tail and the
    counting instance. The two-pass protocol, its bits K6's on all lanes,
    with a cold cache, with the cache that call returned, and with
    ``carried``, the cache the render's lanes carry into this bounce (i32
    per path lane, or None); each pass as the entry runs it
    (``sparse.cached_passes``) held to its culled model and timed alone
    beside its bound (a pass 2 on the whole wavefront is the full lists'
    run); the compaction between the passes (csrc/two_pass.cu's compact
    entry) by ``check_compact``, its rows appended to ``select_rows``."""
    from pathtracerpython_tpu_torch.kernels import intersect, sparse
    from pathtracerpython_tpu_torch.ops.sort import permute_minor

    r_blk = sparse.R_BLK
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    cull = sparse.scene_cluster_cull_boxes(scene)
    o3, d3, maxd, rel = (x.contiguous() for x in (
        shadow.o3, shadow.d3, shadow.maxd, shadow.relevant))
    n = o3.shape[1]
    lists = sparse.window_lists(aabb8, o3, d3, maxd, r_blk)
    launch = lambda rays, lst, stats=None: sparse._launch_any_hit_idx(
        *rays, tripack, aabb8, lst, r_blk, cull, stats)
    plain = lambda rays, lst: sparse.sparse_any_hit_idx_plain(
        *rays, tripack, aabb8, lst, r_blk)
    occ_a, cl_a = launch((o3, d3, maxd), lists)
    err = hold_bits(f"K7 {label} full lists on all lanes", occ_a, occ6,
                    tripack, o3, d3, maxd, against="K6")
    lanes, rays_s, sub = block_subset([o3, d3, maxd], lists, r_blk, stride)
    got = launch(rays_s, sub)
    if not (torch.equal(got[0], occ_a[lanes])
            and torch.equal(got[1], cl_a[lanes])):
        fail(f"K7 {label}: the checked blocks' outputs differ from the same "
             "lanes' on all blocks")
    full = k7_model(rays_s, sub, scene, cull)
    (occ_p, cl_p), p_ms = once_ms(lambda: plain(rays_s, sub))
    err = max(err, hold_k7(f"K7 {label} full lists", got, full, tripack,
                           rays_s, cl_p))
    agree_p, _ = check_bits(f"K7 {label} against plain, full lists", got[0],
                            occ_p)
    cl_agree = (got[1] == cl_p).float().mean().item()
    ks_ms = cuda_ms(lambda: launch(rays_s, sub), 10)
    ka_ms = ks_ms if stride == 1 else cuda_ms(
        lambda: launch((o3, d3, maxd), lists), 10)
    b = full["bound"]
    if ks_ms < b[0]:
        fail(f"K7 {label}: kernel {ks_ms} ms reads under its bound {b[0]} "
             "ms")
    x = split_walk_extras(f"K7 {label}", launch, (o3, d3, maxd), lists,
                          r_blk, (occ_a, cl_a), tripack, tripack, aabb8,
                          cull, intersect.CLASSIC)
    err = max(err, x["err"])

    def protocol(what, guess):
        run = lambda: sparse.sparse_any_hit_cached_cm(o3, d3, maxd, scene,
                                                      guess, relevant=rel)
        occ, cl = run()
        e = hold_bits(f"K7 {label} {what} cache on all lanes", occ, occ6,
                      tripack, o3, d3, maxd, against="K6")
        if bool(((cl >= 0) != occ).any()):
            fail(f"K7 {label} {what} cache: a blocking cluster without an "
                 "occluded lane, or the reverse")
        first, second, sel = sparse.cached_passes(o3, d3, maxd, tripack,
                                                  aabb8, cull, guess, rel)
        check_compact(f"K7 {label} {what} cache", o3, d3, maxd,
                      ~first.occ & rel, select_rows)
        both = {"pass 1": first} if sel is None else {"pass 1": first,
                                                      "pass 2": second}
        passes = {}
        for name, p in both.items():
            model = k7_model(p.rays, p.lists, scene, cull)
            e = max(e, hold_k7(f"K7 {label} {what} cache, {name}",
                               (p.occ, p.cl), model, tripack, p.rays,
                               plain(p.rays, p.lists)[1]))
            passes[name] = {"lanes": p.rays[0].shape[1],
                            "ms": cuda_ms(lambda: launch(p.rays, p.lists),
                                          10),
                            "bound_ms": model["bound"][0],
                            "bound_by": model["bound"][1],
                            "longest_list": int(p.lists.ncand.max())}
        if sel is None:
            passes["pass 2"] = {"lanes": n, "ms": ka_ms, "whole": True}
        ms = cuda_ms(run, 5)
        log(f"[2] K7 {label} {what} cache: occlusion equal to K6 on all "
            f"lanes, each pass equal to its culled model; "
            f"{json.dumps(passes)} (compacted pass 2 cap "
            f"{sparse.pass2_size(n)} of {n} lanes); both passes with lists "
            f"{ms:.3f} ms")
        return cl, e, ms, passes

    cold = torch.full((n,), -1, dtype=torch.int32, device=o3.device)
    cl_cold, e_cold, cold_ms, cold_p = protocol("cold", cold)
    _, e_warm, warm_ms, warm_p = protocol("returned", cl_cold)
    carried_ms = carried_p = None
    if carried is not None:
        guess = carried[None, :].expand(NEE_SAMPLES, -1).reshape(-1)
        guess = permute_minor(guess, shadow.order).contiguous()
        _, e_c, carried_ms, carried_p = protocol("carried", guess)
        err = max(err, e_c)
    err = max(err, e_cold, e_warm)
    nc = lists.ncand.float()
    log(f"[2] K7 {label}: {n} shadow lanes in {lists.ncand.shape[0]} blocks "
        f"of {r_blk}, candidates per block mean {nc.mean().item():.1f} max "
        f"{int(nc.max().item())}; full lists on all lanes: bits equal to "
        f"K6; on {sub.ncand.shape[0]} blocks ({rays_s[0].shape[1]} lanes) "
        f"bits and clusters equal to its culled model, against the "
        f"un-culled plain version bits {agree_p:.6f}, clusters "
        f"{cl_agree:.6f}; kernel on all blocks {ka_ms:.3f} ms, on the "
        f"{x['short_blocks']} blocks with lists of at most {x['cut']} "
        f"clusters (99%) {x['kernel_short99_ms']:.3f} ms; on the checked "
        f"blocks kernel {ks_ms:.3f} ms, culled model {full['ms']:.3f} ms, "
        f"plain {p_ms:.3f} ms, bound {b[0]:.4f} ms by {b[1]} "
        f"({full['pairs_needed']} pairs needed), gate-pairs bound "
        f"{full['gate_pairs_bound_ms']:.4f} ms ({full['gate_pairs']} pairs "
        f"through the gate)")
    log(extras_text(f"K7 {label} (first-slot merge)", x))
    report.append(report_row(
        label, err, ks_ms, p_ms, b, kernel_all_ms=ka_ms, model_ms=full["ms"],
        over_bound=ks_ms / b[0], cl_agree_plain=cl_agree,
        **{k: full[k] for k in ("pairs_needed", "gate_pairs",
                                "gate_pairs_bound_ms", "model_pairs_tested")},
        **extras_row(x), longest_list=int(nc.max().item()), cold_ms=cold_ms,
        warm_ms=warm_ms, carried_ms=carried_ms, cold_passes=cold_p,
        warm_passes=warm_p, carried_passes=carried_p,
        pass1_ms=warm_p["pass 1"]["ms"],
        pass1_bound_ms=warm_p["pass 1"]["bound_ms"],
        pass2_ms=warm_p["pass 2"]["ms"],
        pass2_bound_ms=warm_p["pass 2"].get("bound_ms")))


def check_k3_sparse(label, scene, o3, d3u, shadow, stride, rows, k5, occ6):
    """K3's cluster-sparse sweeps on one sorted wavefront of the large
    scene: each against its plain version on every ``stride``-th block,
    against the dense Plücker sweep on all lanes (bit for bit, the nearest
    sweep at blocks of 512 and 1024), and against its classic twin
    (``k5``: K5's (t, idx) at blocks of 512; ``occ6``: K6's bits) under
    the forms' contract."""
    from pathtracerpython_tpu_torch.kernels import intersect, sparse

    tripack = sparse.pack_for_sparse(scene)
    pack36 = intersect.scene_plucker_pack(scene, sparse.PACK_ROWS)
    plucker = dict(pack=pack36, dense_name="K3",
                   flops=FLOPS_PER_PAIR_PLUCKER)
    (t_d, i_d), d_ms = once_ms(lambda: intersect.nearest_t_idx_cm(
        o3, d3u, scene, mt_impl="plucker"))
    t3, i3 = check_nearest_walk(
        "K3 sparse nearest", label, scene, o3, d3u, stride,
        rows["K3 sparse nearest"], (t_d, i_d, d_ms), r_blk=sparse.R_BLK,
        launch=sparse._launch_plucker,
        plain=sparse.sparse_nearest_plucker_plain,
        wrapper=lambda o, d, s: sparse.sparse_nearest_t_idx_cm(
            o, d, s, mt_impl="plucker"), **plucker)
    t3h, i3h = sparse.sparse_nearest_t_idx_cm(
        o3, d3u, scene, r_blk=sparse.R_BLK_HYBRID_NEAREST, mt_impl="plucker")
    for r_blk, t, i in ((sparse.R_BLK, t3, i3),
                        (sparse.R_BLK_HYBRID_NEAREST, t3h, i3h)):
        diff = (t - t_d).abs().max().item()
        if diff != 0.0 or not bool((i == i_d).all()):
            fail(f"K3 sparse nearest {label}, blocks of {r_blk}: not equal "
                 f"to the dense Plücker sweep (t max abs diff {diff})")
    agree_c, grazing_c, err_c = check_winners(
        f"K3 sparse nearest {label} against K5", tripack, o3, d3u, t3, i3,
        *k5, min_agree=FORM_MIN_AGREE, margin=FORM_MARGIN, t_tol=FORM_T_TOL)
    classic_ms = rows["K5@512"][-1]["kernel_all_ms"]
    rows["K3 sparse nearest"][-1].update(classic_ms=classic_ms,
                                         classic_agree=agree_c)
    log(f"[2] K3 sparse nearest {label}: equal to the dense Plücker sweep "
        f"at blocks of 512 and 1024 (max abs diff 0); against K5: winners "
        f"{agree_c:.6f} ({grazing_c} grazing), t max abs diff {err_c:.3g}; "
        f"kernel on all blocks "
        f"{rows['K3 sparse nearest'][-1]['kernel_all_ms']:.3f} ms (K5 "
        f"{classic_ms:.3f} ms)")

    sh = [x.contiguous() for x in (shadow.o3, shadow.d3, shadow.maxd)]
    dense = once_ms(lambda: intersect.any_hit_cm(*sh, scene,
                                                 mt_impl="plucker"))
    occ3 = check_any_hit_walk(
        "K3 sparse any-hit", label, scene, shadow, stride,
        rows["K3 sparse any-hit"], dense, r_blk=sparse.R_BLK,
        launch=sparse._launch_plucker_any_hit,
        wrapper=lambda o, d, m, s: sparse.sparse_any_hit_cm(
            o, d, m, s, mt_impl="plucker"), **plucker)
    agree_c = check_form_bits(f"K3 sparse any-hit {label}", scene, *sh, occ3,
                              occ6)
    classic_ms = rows["K6"][-1]["kernel_all_ms"]
    rows["K3 sparse any-hit"][-1].update(classic_ms=classic_ms,
                                         classic_agree=agree_c)
    log(f"[2] K3 sparse any-hit {label}: equal to the dense Plücker any-hit "
        f"(max abs diff 0); bits agree with K6 on {agree_c:.6f} of lanes; "
        f"kernel on all blocks "
        f"{rows['K3 sparse any-hit'][-1]['kernel_all_ms']:.3f} ms (K6 "
        f"{classic_ms:.3f} ms)")


# The two-pass protocol of the uncached sweeps (kernels/sparse.py:
# two_pass_nearest, two_pass_any_hit) on the 100k field's wavefronts: K5 in
# blocks of 1024 (the hybrid's) and 512 (accel="sparse"), K6, and the
# select-and-compact kernel csrc/two_pass.cu (whose compact entry the
# occluder cache runs, check_compact).
TWO_PASS_KEYS = ("K5 two-pass", "K5@512 two-pass", "K6 two-pass",
                 "two-pass select")
TWO_PASS_ROW_KEYS = ("pass1_ms", "select_ms", "library_select_ms",
                     "pass2_lists_ms", "pass2_ms", "fallback_ms",
                     "one_pass_ms", "survivors", "survivor_share", "branch",
                     "kernel_unqueued_ms", "lanes", "slots", "lane_m")
TWO_PASS_NEVER_FITS = 10**6  # m_div whose pass 2 is one block: the big branch
# Operations of one slab test (cluster.cuh: slab_hit): per axis two
# subtractions, two products, a min and a max; two mins and two maxes across
# the axes, the clamp, and the comparison with its slack
SLAB_OPS = 22
# Bytes a pass-2 slot takes: its lane (int64) and its ray (o, d: 6 floats;
# the any-hit's and the cache's also the window)
SLOT_BYTES = {False: 8 + 24, True: 8 + 28}


def two_pass_turns(one, two, reps: int = 5) -> tuple[float, float]:
    """The one-pass and the two-pass wrapper timed in turns on one card
    (one, two, two, one; ``reps`` calls a turn after one warm-up call
    each): each one's mean ms over its two turns."""
    one()
    two()
    times = {one: [], two: []}
    for fn in (one, two, two, one):
        times[fn].append(cuda_ms(fn, reps))
    return statistics.mean(times[one]), statistics.mean(times[two])


def library_compaction(flags, m, o3, d3u, maxd):
    """The compaction as the port ran it before the select-and-compact
    kernel, with library calls: ``torch.nonzero`` (which reads the count
    back to the host), then the parked gather of the first m lanes into m
    slots (PARK_ORIGIN / PARK_DIR, window 1 past them). Returns (sel
    i64[min(count, m)], count, rays)."""
    from pathtracerpython_tpu_torch.ops.sort import PARK_DIR, PARK_ORIGIN

    sel = torch.nonzero(flags).flatten()
    count = sel.shape[0]
    sel = sel[:m]
    k = sel.shape[0]
    o2 = o3.new_tensor(PARK_ORIGIN)[:, None].repeat(1, m)
    d2 = o3.new_tensor(PARK_DIR)[:, None].repeat(1, m)
    o2[:, :k] = o3[:, sel]
    d2[:, :k] = d3u[:, sel]
    if maxd is None:
        return sel, count, (o2, d2)
    md2 = torch.ones(m, dtype=maxd.dtype, device=maxd.device)
    md2[:k] = maxd[sel]
    return sel, count, (o2, d2, md2)


def hold_selection(what, got, want, flags, n: int, library) -> int:
    """The kernel's Selection ``got`` against its plain twin's ``want``
    (every field bit for bit) and against the library path's (sel, count,
    rays) ``library``: the same count, the same lanes in the same order (the
    slots up to the count where it fits the cap), the same rays. Fails
    otherwise; returns the count."""
    fields = ("sel", "count", "taken", "ncand_fb")
    for f in fields:
        g, w = getattr(got, f), getattr(want, f)
        if (g is None) != (w is None) or (g is not None
                                          and not torch.equal(g, w)):
            fail(f"{what}: {f} differs from the plain twin's")
    for k, (g, w) in enumerate(zip(got.rays, want.rays)):
        if not torch.equal(g, w):
            fail(f"{what}: pass-2 ray field {k} differs from the plain "
                 f"twin's on {int((g != w).sum())} of {g.numel()} values")
    if got.flags is not None and not torch.equal(got.flags, flags):
        fail(f"{what}: flags differ from the plain twin's")
    count = int(got.count[0])
    m = got.sel.shape[0]
    sel, lib_count, rays = library
    if lib_count != count:
        fail(f"{what}: count {count}, torch.nonzero's {lib_count}")
    if bool(got.taken[0]) != (count > m):
        fail(f"{what}: taken is {bool(got.taken[0])} at count {count} of "
             f"{m} slots")
    if count <= m:
        if not (torch.equal(got.sel[:count], sel)
                and bool((got.sel[count:] == n).all())):
            fail(f"{what}: the slots are not torch.nonzero's lanes")
        if not all(torch.equal(g, w) for g, w in zip(got.rays, rays)):
            fail(f"{what}: the rays differ from the library gather's")
    elif not bool((got.sel == n).all()):
        fail(f"{what}: a slot is not parked past the cap")
    return count


def check_compact(label, o3, d3u, maxd, unfinished, rows) -> dict:
    """csrc/two_pass.cu's compact entry (``sparse.select_compact``, the
    occluder cache's pass-2 compaction) on the lanes ``unfinished``: bit
    for bit its plain twin, torch.nonzero's lanes in its order, and the
    library gather's rays; timed (queued: device time; and unqueued)
    against its bound and the library path it replaced (torch.nonzero, its
    host read and the gather). Appends to ``rows``; returns the row."""
    from pathtracerpython_tpu_torch.kernels import sparse

    n = o3.shape[1]
    m = sparse.pass2_size(n)
    step = lambda: sparse.select_compact(unfinished, m, o3, d3u, maxd)
    got = step()
    want, p_ms = once_ms(lambda: sparse.select_compact_plain(
        unfinished, m, o3, d3u, maxd))
    library = lambda: library_compaction(unfinished, m, o3, d3u, maxd)
    cnt = hold_selection(f"compact {label}", got, want, None, n, library())
    ms = cuda_ms(step, 10, queued=True)
    unqueued = cuda_ms(step, 10)
    lib_ms = cuda_ms(library, 10)
    # the flags read once, every slot written once, the count and the
    # branch word; the survivors' rays only where they fit the cap (past
    # it every slot is parked, and no ray need be read)
    nbytes = (tensor_bytes(unfinished) + (cnt * 28 if cnt <= m else 0)
              + m * SLOT_BYTES[True] + 5)
    b = bound(nbytes, 0, 0)
    branch = "compacted" if cnt <= m else "whole"
    log(f"[2] select_compact {label}: {n} lanes, {cnt} open "
        f"({cnt / n:.4f}), {m} slots: the {branch} branch; slots, count, "
        f"rays and branch equal to the plain twin's and to torch.nonzero's "
        f"order; kernel {ms:.4f} ms (unqueued {unqueued:.4f}), library path "
        f"(torch.nonzero and the gather) {lib_ms:.4f} ms, plain {p_ms:.3f} "
        f"ms, bound {b[0]:.4f} ms by {b[1]}")
    row = report_row(f"compact {label}", 0.0, ms, p_ms, b, library_ms=lib_ms,
                     kernel_unqueued_ms=unqueued, lanes=n, slots=m,
                     survivors=cnt, survivor_share=cnt / n, branch=branch,
                     lane_m=0)
    rows.append(row)
    return row


def check_two_pass(kind, name, label, scene, rays, r_blk, want, one_row,
                   rows, plain: bool) -> None:
    """The two-pass protocol of ``kind`` ("nearest": K5; "any-hit": K6) on
    one wavefront ``rays`` ((o3, d3u) or (o3, d3u, maxd)) in blocks of
    ``r_blk``, against ``want``, the one-pass kernel's result: the
    protocol's steps run and timed alone as the wrapper runs them (pass 1
    over the first PASS1_K slots, the select-and-compact kernel, pass 2's
    lists and pass 2 over the slots, the fallback over the full lists with
    the counts the kernel left), the kernel's flags, bound, slots, count,
    branch and rays equal to its plain twins' bit for bit and its lanes to
    torch.nonzero's, and the wrapper in both branches (the one M_DIV takes,
    the other forced by ``m_div``) equal to ``want`` bit for bit; the
    wrapper timed in turns with the one-pass wrapper. The kernel is timed
    against its bound and against the library path it replaced (the flags,
    torch.nonzero and the gather). ``one_row``: the one-pass kernel's
    report row of the same wavefront, whose bound the protocol shares (the
    same function on the same inputs). ``plain``: also time the protocol
    with every step plain (the walks at full width take seconds). Appends
    to ``rows[name]`` and to ``rows["two-pass select"]``."""
    from pathtracerpython_tpu_torch.kernels import intersect, sparse

    nearest = kind == "nearest"
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    box = sparse.scene_cluster_box(scene)
    o3, d3u = rays[0], rays[1]
    maxd = None if nearest else rays[2]
    n = o3.shape[1]
    if nearest:
        lists = sparse.block_lists(aabb8, o3, d3u, torch.full(
            (-(-n // r_blk),), intersect.BIG, device=o3.device), r_blk)
        launch = lambda r, li, words=None: sparse._launch(
            *r, tripack, aabb8, li, r_blk, words=words)
        plain_sweep = lambda r, li: sparse.sparse_nearest_plain(
            *r, tripack, aabb8, li, r_blk)
        wrapper = lambda k, m_div=sparse.M_DIV: sparse.sparse_nearest_t_idx_cm(
            o3, d3u, scene, r_blk=r_blk, two_pass=k, m_div=m_div)
        make_lists = lambda r: sparse.block_lists(aabb8, r[0], r[1], torch.full(
            (r[0].shape[1] // r_blk,), intersect.BIG, device=o3.device),
            r_blk)
    else:
        lists = sparse.window_lists(aabb8, o3, d3u, maxd, r_blk)
        cull = sparse.scene_cluster_cull_boxes(scene)
        launch = lambda r, li, words=None: sparse._launch_any_hit(
            *r, tripack, aabb8, li, r_blk, cull)
        plain_sweep = lambda r, li: sparse.sparse_any_hit_plain(
            *r, tripack, aabb8, li, r_blk)
        wrapper = lambda k, m_div=sparse.M_DIV: sparse.sparse_any_hit_cm(
            o3, d3u, maxd, scene, two_pass=k, m_div=m_div)
        make_lists = lambda r: sparse.window_lists(aabb8, *r, r_blk)
    k = sparse.PASS1_K
    head, drops = sparse.truncate_lists(lists, k)
    m = sparse.pass2_size(n, r_blk, sparse.M_DIV)

    def pass1():
        words = sparse.walk_words(n, o3.device) if nearest else None
        return launch(rays, head, words), words

    def select(first, words, slots=m, **kw):
        # the wrapper's step: the kernel and its finish, the box cached
        if nearest:
            return sparse.nearest_select_compact(
                o3, d3u, aabb8, box, drops, r_blk, *first, words, slots,
                lists.ncand, **kw)
        return sparse.any_hit_select_compact(
            o3, d3u, maxd, first, aabb8, box, drops, r_blk, slots,
            lists.ncand, **kw)

    def plain_flags(first):
        if nearest:
            reach = torch.where(first[1] >= 0, first[0], intersect.BIG)
            return sparse.two_pass_flags_plain(o3, d3u, aabb8, drops, r_blk,
                                               reach, box=box)
        return sparse.two_pass_flags_plain(
            o3, d3u, aabb8, drops, r_blk, maxd,
            sparse.any_hit_open(first, maxd), box=box)

    def library(first, words):
        # the path the kernel replaced: the finality flags (the kernel's,
        # one slot), torch.nonzero and the gather
        flags = select(first, words, 1, want_flags=True).flags
        return library_compaction(flags, m, o3, d3u, maxd)

    first, words = pass1()
    s = select(first, words, want_flags=True, want_ne=True)
    (want_flags, want_ne), flags_plain_ms = once_ms(lambda: plain_flags(first))
    if not (torch.equal(s.flags, want_flags) and torch.equal(s.ne, want_ne)):
        fail(f"two-pass select {name} {label}: flags differ from its plain "
             f"twin on {int((s.flags != want_flags).sum())} lanes, the bound "
             f"on {int((s.ne != want_ne).sum())}")
    want_s, compact_plain_ms = once_ms(lambda: sparse.select_compact_plain(
        want_flags, m, o3, d3u, maxd, lists.ncand))
    cnt = hold_selection(f"two-pass select {name} {label}", s, want_s,
                         want_flags, n, library(first, words))
    bare = select(first, words)
    if not all(torch.equal(a, b) for a, b in zip(
            (bare.sel, bare.count, bare.taken, *bare.rays),
            (s.sel, s.count, s.taken, *s.rays))):
        fail(f"two-pass select {name} {label}: the launch without flags and "
             "bound gives other slots")
    natural = "compacted" if cnt <= m else "whole"
    # pass 2 over the compacted survivors, at the cap that holds them
    m2 = m if cnt <= m else sparse.pass2_size(n, r_blk, 1)
    rays2 = (s if cnt <= m else select(first, words, m2)).rays
    lists2 = make_lists(rays2)
    fallback = lists._replace(ncand=s.ncand_fb)
    pass1_ms = cuda_ms(pass1, 10)
    kernel_ms = cuda_ms(lambda: select(first, words), 10, queued=True)
    unqueued_ms = cuda_ms(lambda: select(first, words), 10)
    library_ms = cuda_ms(lambda: library(first, words), 10)
    lists2_ms = cuda_ms(lambda: make_lists(rays2), 10)
    pass2_ms = cuda_ms(lambda: launch(rays2, lists2), 10)
    fallback_ms = cuda_ms(lambda: launch(rays, fallback), 10)
    one_ms, two_ms = two_pass_turns(lambda: wrapper(0), lambda: wrapper(k))
    # both branches through the wrapper, bit for bit
    forced = TWO_PASS_NEVER_FITS if natural == "compacted" else 1
    for m_div in (sparse.M_DIV, forced):
        got = wrapper(k, m_div)
        got = got if nearest else (got,)
        wants = want if nearest else (want,)
        diff = max(float((g.float() - w.float()).abs().max())
                   for g, w in zip(got, wants))
        if not all(torch.equal(g, w) for g, w in zip(got, wants)):
            fail(f"{name} {label}, m_div {m_div}: not equal to the one-pass "
                 f"sweep (max abs diff {diff})")
    if forced == TWO_PASS_NEVER_FITS and cnt <= sparse.pass2_size(
            n, r_blk, forced):
        fail(f"{name} {label}: m_div {forced} did not force the whole "
             f"wavefront ({cnt} survivors)")
    p_ms = None
    if plain:
        def plain_two_pass():
            p1 = plain_sweep(rays, head)
            fl, _ = plain_flags(p1)
            sp = sparse.select_compact_plain(fl, m, o3, d3u, maxd,
                                             lists.ncand)
            p2 = plain_sweep(sp.rays, make_lists(sp.rays))
            p_all = plain_sweep(rays, lists._replace(ncand=sp.ncand_fb))
            if nearest:
                return tuple(torch.where(sp.taken, a, sparse.scatter_back(
                    b, sp.sel, c)) for a, b, c in zip(p_all, p1, p2))
            return torch.where(sp.taken, p_all,
                               sparse.scatter_back(p1, sp.sel, p2))

        _, p_ms = once_ms(plain_two_pass)
    # the kernel's bound: the bytes it must move (the rays, pass 1's state,
    # the drops and the boxes they name once, the full lists' counts and the
    # fallback's, every slot of pass 2 written once) or its slab tests,
    # whichever takes longer
    state = (words,) if nearest else (first, maxd)
    named = int(drops.ids[drops.keys < intersect.BIG].unique().numel())
    nbytes = (tensor_bytes(o3, d3u, *state, *drops, lists.ncand, s.ncand_fb)
              + named * BOX_FLOATS * 4 + m * SLOT_BYTES[not nearest] + 5)
    b_sel = bound(nbytes, n * (drops.ids.shape[1] + 1), SLAB_OPS)
    share = cnt / n
    log(f"[2] {name} {label}: {n} lanes in blocks of {r_blk}, pass 1 over "
        f"{k} of at most {int(lists.ncand.max())} slots a block; "
        f"{cnt} unfinished ({share:.4f}), pass 2 cap {m} (M_DIV "
        f"{sparse.M_DIV}): the {natural} branch; both branches equal to the "
        f"one-pass sweep bit for bit (m_div {sparse.M_DIV} and {forced}); "
        f"flags, bound, slots, count, branch and rays equal to the plain "
        f"twins', the slots torch.nonzero's lanes")
    log(f"[2] {name} {label} times: pass 1 {pass1_ms:.3f} ms, select and "
        f"compact {kernel_ms:.4f} ms (unqueued {unqueued_ms:.4f}; the "
        f"library path it replaced, flags, torch.nonzero and the gather, "
        f"{library_ms:.4f}; plain {flags_plain_ms + compact_plain_ms:.3f}; "
        f"bound {b_sel[0]:.4f} by {b_sel[1]}), pass 2's lists "
        f"{lists2_ms:.3f} ms, pass 2 {pass2_ms:.3f} ms over {m2} lanes, the "
        f"fallback over the lists with the kernel's counts {fallback_ms:.3f} "
        f"ms; in turns: two-pass {two_ms:.3f} ms, one-pass {one_ms:.3f} ms "
        f"(wrappers, lists included)" + (
            "" if p_ms is None else f"; plain two-pass {p_ms:.3f} ms"))
    steps = dict(pass1_ms=pass1_ms, select_ms=kernel_ms,
                 library_select_ms=library_ms, pass2_lists_ms=lists2_ms,
                 pass2_ms=pass2_ms, fallback_ms=fallback_ms,
                 one_pass_ms=one_ms, survivors=cnt, survivor_share=share,
                 pass2_cap=m, pass2_lanes=m2, branch=natural,
                 forced_m_div=forced)
    rows[name].append(report_row(
        label, 0.0, two_ms, p_ms, (one_row["bound_ms"], one_row["bound_by"]),
        **steps))
    rows["two-pass select"].append(report_row(
        f"{name} {label}", 0.0, kernel_ms, flags_plain_ms + compact_plain_ms,
        b_sel, library_ms=library_ms, kernel_unqueued_ms=unqueued_ms,
        lanes=n, slots=m, lane_m=drops.ids.shape[1], survivors=cnt,
        survivor_share=share, branch=natural))


def check_probes(rows) -> None:
    """Every variant of P1 and P2 at the probes' default sizes against its
    plain version, with times and bounds; fails if a variant reads under
    its bound. P1's Plücker bounds count the plane on the pairs whose sides
    agree only, as the sign-first kernels compute it."""
    from pathtracerpython_tpu_torch.probes import bf16_probe, mma_probe

    n, t_count = 262144, 512
    o3, d3, tripack = mma_probe.make_inputs(n, t_count, 0, "cuda")
    packs = mma_probe.make_packs(tripack)
    pairs = n * t_count
    _, inside = mma_probe.inside_pairs(o3, d3, packs.pack36)
    log(f"[2] P1: {inside} of {pairs} pairs ({inside / pairs:.5f}) have "
        f"sides of one sign")
    for variant in mma_probe.VARIANTS:
        run = lambda: mma_probe.probe(o3, d3, tripack, variant, packs)
        got = run()
        want, p_ms = once_ms(lambda: mma_probe.probe_plain(o3, d3, tripack,
                                                           variant))
        diff = mma_probe.compare(tripack, o3, d3, got, want)
        on_mma = "tf32" in variant
        agree = 1.0 - diff["winner_diff_share"]
        if agree < (MMA_MIN_AGREE if on_mma else MIN_IDX_AGREE):
            fail(f"P1 {variant}: winners agree with the plain version on "
                 f"{agree:.6f} of rays")
        # on the CUDA cores the kernel does the plain version's float32
        # operations in its order: the same bits
        if not on_mma and not (torch.equal(got[0], want[0])
                               and torch.equal(got[1], want[1])):
            fail(f"P1 {variant}: (t, index) differ from the plain version's "
                 f"bits")
        if diff["max_t_err"] > 1e-5:
            fail(f"P1 {variant}: t differs from the plain version by "
                 f"{diff['max_t_err']}")
        k_ms = cuda_ms(run, 10)
        nbytes = tensor_bytes(o3, d3, tripack if variant == "mt"
                              else packs.pack36, *got)
        plane_ms = inside * PLANE_FLOPS_PER_PAIR / PEAK_FP32_FLOPS * 1e3
        if variant == "mt":
            b = bound(nbytes, pairs, FLOPS_PER_PAIR_TILE)
        elif on_mma:
            passes = 3 if variant == "plucker_3xtf32" else 1
            b = bound_ops(nbytes, pairs * passes * MMA_FLOPS_PER_PAIR
                          / PEAK_TF32_FLOPS * 1e3 + plane_ms)
        else:
            b = bound_ops(nbytes, pairs * SIDE_FLOPS_PER_PAIR
                          / PEAK_FP32_FLOPS * 1e3 + plane_ms)
        if k_ms < b[0]:
            fail(f"P1 {variant}: kernel {k_ms} ms reads under its bound "
                 f"{b[0]} ms")
        log(f"[2] P1 {variant}: {n} rays x {t_count} tris, winners agree "
            f"with plain {agree:.6f}, t max abs err {diff['max_t_err']:.3g}; "
            f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b[0]:.4f} ms "
            f"by {b[1]} (kernel {k_ms / b[0]:.1f}x)")
        rows[f"P1 {variant}"].append(report_row(
            "probe tile", diff["max_t_err"], k_ms, p_ms, b,
            over_bound=k_ms / b[0], inside_pairs=inside, pairs=pairs))

    n = 1 << 20
    o3, d3, tripack = bf16_probe.make_inputs(n, t_count, 0, "cuda")
    pairs = n * t_count
    for variant, peak in (("f32", PEAK_FP32_FLOPS),
                          ("bf16", PEAK_BF16_CORE_FLOPS)):
        run = lambda: bf16_probe.hit_count(o3, d3, tripack, variant)
        got = run()
        want, p_ms = once_ms(lambda: bf16_probe.hit_count_plain(
            o3, d3, tripack, variant))
        same = (got == want).float().mean().item()
        err = (got - want).abs().max().item()
        # every operation rounds as the plain version's: equal counts
        if not torch.equal(got, want):
            fail(f"P2 {variant}: hit counts agree with the plain version on "
                 f"{same:.6f} of rays (max abs diff {err})")
        k_ms = cuda_ms(run, 10)
        b = bound_ops(tensor_bytes(o3, d3, tripack, got),
                      pairs * FLOPS_PER_PAIR_TILE / peak * 1e3)
        if k_ms < b[0]:
            fail(f"P2 {variant}: kernel {k_ms} ms reads under its bound "
                 f"{b[0]} ms")
        log(f"[2] P2 {variant}: {n} rays x {t_count} tris, hit counts agree "
            f"with plain on {same:.6f} of rays, max abs diff {err:.3g}; "
            f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b[0]:.4f} ms "
            f"by {b[1]} (kernel {k_ms / b[0]:.1f}x)")
        rows[f"P2 {variant}"].append(report_row(
            "probe tile", err, k_ms, p_ms, b, over_bound=k_ms / b[0]))


def pack_build_cost(scene) -> None:
    """What deriving the Plücker packs costs: device kernels and ms of one
    ``plucker_pack`` of the scene's padded pack. A render pays it once per
    scene (``scene_plucker_pack`` caches), not once per bounce."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pathtracerpython_tpu_torch.kernels import intersect, sparse

    tripack = sparse.pack_for_sparse(scene)
    ms = cuda_ms(lambda: intersect.plucker_pack(tripack), 5)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        intersect.plucker_pack(tripack)
        torch.cuda.synchronize()
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
    log(f"[2] Plücker packs of {tripack.shape[0]} rows: {launches} device "
        f"kernels, {ms:.3f} ms, once per scene")


def cull_build_cost(scene) -> None:
    """What deriving the cull boxes costs: ms of one ``cull_boxes`` and of
    one ``nearest_cull_boxes`` of the scene's pack (tile and group tables).
    A render pays each once per scene (``scene_cull_boxes``,
    ``scene_nearest_cull_boxes`` cache them), not once per bounce."""
    from pathtracerpython_tpu_torch.kernels import intersect

    tripack = intersect.scene_tripack(scene)
    ms = cuda_ms(lambda: intersect.cull_boxes(tripack), 5)
    near_ms = cuda_ms(lambda: intersect.nearest_cull_boxes(tripack), 5)
    log(f"[2] cull boxes of {tripack.shape[0]} rows (tiles of "
        f"{intersect.TILE_ROWS}, groups of {intersect.CULL_GROUP} rows): "
        f"{ms:.3f} ms for the shadow sweeps', {near_ms:.3f} ms for the "
        "nearest sweep's, each once per scene")


# What the culled sweeps' rows add to their entries of the kernels line,
# and what the split any-hit walks' rows add.
CULL_KEYS = ("all_pairs_bound_ms", "pairs_tested", "pairs_needed",
             "pairs_all", "tiles_skipped", "groups_skipped")
ANY_HIT_WALK_KEYS = ("gate_pairs_bound_ms", "gate_pairs", "units",
                     "units_stopped_at_once", "visits", "span_tests",
                     "mid_tests", "group_tests", "kernel_all_ms",
                     "kernel_short99_ms")
K3_KEYS = ("K3 nearest", "K3 any-hit", "K3 sparse nearest",
           "K3 sparse any-hit")
P1_KEYS = ("P1 mt", "P1 plucker_fma", "P1 plucker_tf32", "P1 plucker_3xtf32")
P2_KEYS = ("P2 f32", "P2 bf16")


def phase2_kernels(scenes, morton, many, large) -> dict:
    """``scenes``: [(name, scene)] of the dense wavefronts; ``morton``: the
    "boxfield" scene's triangles packed in morton order; ``many``: the same
    field at MANY_NEE_SIZE; ``large``: the 100k-triangle field."""
    from pathtracerpython_tpu_torch.kernels import intersect, sparse, walker

    rows = {k: [] for k in ("K1", "K2", "K4", "K5", "K5@512", "K6", "K7",
                            "K8", "K9", *K3_KEYS, *P1_KEYS, *P2_KEYS,
                            *TWO_PASS_KEYS,
                            "K1 morton", "K3 nearest morton", "K2 morton",
                            "K4 morton", "K1 large100k")}
    for name, scene in scenes:
        for b, (o3, d3u, p3, n3, u, shadow, _) in enumerate(
                wavefronts(scene, CORNELL_SPP), start=1):
            label = f"{name} bounce {b}"
            k1, ref1 = check_nearest("classic", label, scene, o3, d3u,
                                     rows["K1"])
            _, ref3 = check_nearest("plucker", label, scene, o3, d3u,
                                    rows["K3 nearest"], classic=k1)
            # the fused NEE's samples are the unfused NEE's shadow rays
            counts = own_box_counts(
                intersect.scene_tripack(scene), shadow.o3.contiguous(),
                shadow.d3.contiguous(), shadow.maxd.contiguous())
            k2 = check_k2(label, scene, p3, n3, u, shadow, counts, rows["K2"])
            k4 = check_dense_any_hit("classic", label, scene, shadow, counts,
                                     rows["K4"])
            check_dense_any_hit("plucker", label, scene, shadow, counts,
                                rows["K3 any-hit"], classic=k4)
            if name == "boxfield":
                # the same triangles in morton order: the tile level at
                # work, and the order must not change a bit
                label = f"{name} morton bounce {b}"
                check_nearest("classic", label, morton, o3, d3u,
                              rows["K1 morton"], reference=ref1)
                check_nearest("plucker", label, morton, o3, d3u,
                              rows["K3 nearest morton"], reference=ref3)
                check_k2(label, morton, p3, n3, u, shadow, counts,
                         rows["K2 morton"], reference=k2)
                check_dense_any_hit("classic", label, morton, shadow, counts,
                                    rows["K4 morton"], reference=k4[0])
    # the unfused NEE's wavefronts of the render that launches K4 on a
    # scene of more than one tile
    for b, (_, _, _, _, _, shadow, _) in enumerate(
            wavefronts(many, MANY_NEE_SPP, MANY_NEE_SAMPLES), start=1):
        label = f"{MANY_NEE_LABEL} bounce {b}"
        counts = own_box_counts(
            intersect.scene_tripack(many), shadow.o3.contiguous(),
            shadow.d3.contiguous(), shadow.maxd.contiguous())
        k4 = check_dense_any_hit("classic", label, many, shadow, counts,
                                 rows["K4"])
        check_dense_any_hit("plucker", label, many, shadow, counts,
                            rows["K3 any-hit"], classic=k4)
    # the wavefronts of the sparse render with the occluder cache: the rays
    # are every hierarchy's (the sweeps agree bit for bit), and the lanes
    # carry the cache into the second bounce
    r1024 = sparse.R_BLK_HYBRID_NEAREST
    for b, (o3, d3u, _, _, _, shadow, cache) in enumerate(
            wavefronts(large, LARGE_SPP, accel="sparse", nee_cache="on"),
            start=1):
        stride = 1 if b == 1 else SUBSET_STRIDE
        label = f"large100k bounce {b}"
        dense = check_large_dense(label, large, o3, d3u, r1024,
                                  rows["K1 large100k"])
        t5, i5 = check_nearest_walk(
            "K5", label, large, o3, d3u, stride, rows["K5"], dense,
            r_blk=r1024, launch=sparse._launch,
            plain=sparse.sparse_nearest_plain,
            wrapper=lambda o, d, s: sparse.sparse_nearest_t_idx_cm(
                o, d, s, r_blk=r1024))
        k5 = check_nearest_walk(
            "K5@512", label, large, o3, d3u, stride, rows["K5@512"], dense,
            r_blk=sparse.R_BLK, launch=sparse._launch,
            plain=sparse.sparse_nearest_plain,
            wrapper=sparse.sparse_nearest_t_idx_cm)
        check_nearest_walk(
            "K8", label, large, o3, d3u, stride, rows["K8"], dense,
            r_blk=walker.R_BLK, launch=walker._launch_nearest,
            plain=walker.walker_nearest_plain,
            wrapper=walker.walker_nearest_t_idx_cm, others=[("K5", t5, i5)])
        sh = [x.contiguous() for x in (shadow.o3, shadow.d3, shadow.maxd)]
        dense = once_ms(lambda: intersect.any_hit_cm(*sh, large))
        occ9 = check_any_hit_walk(
            "K9", label, large, shadow, stride, rows["K9"], dense,
            r_blk=walker.R_BLK, launch=walker._launch,
            wrapper=walker.walker_any_hit_cm)
        occ6 = check_any_hit_walk(
            "K6", label, large, shadow, stride, rows["K6"], dense,
            r_blk=sparse.R_BLK, launch=sparse._launch_any_hit,
            wrapper=sparse.sparse_any_hit_cm, others=[("K9", occ9)])
        check_k7(label, large, shadow, cache if b > 1 else None, occ6,
                 stride, rows["K7"], rows["two-pass select"])
        check_k3_sparse(label, large, o3, d3u, shadow, stride, rows, k5, occ6)
        for name, r_blk, want in (("K5 two-pass", r1024, (t5, i5)),
                                  ("K5@512 two-pass", sparse.R_BLK, k5)):
            check_two_pass("nearest", name, label, large, (o3, d3u), r_blk,
                           want, rows[name.replace(" two-pass", "")][-1],
                           rows, plain=b == 1)
        check_two_pass("any-hit", "K6 two-pass", label, large, sh,
                       sparse.R_BLK, occ6, rows["K6"][-1], rows,
                       plain=b == 1)
        log(f"[2] {label}, one wavefront's nearest sweep: dense K1 (culled) "
            f"{rows['K1 large100k'][-1]['kernel_all_ms']:.3f} ms, K5@1024 "
            f"{rows['K5'][-1]['kernel_all_ms']:.3f} ms, K5@512 "
            f"{rows['K5@512'][-1]['kernel_all_ms']:.3f} ms, K8 "
            f"{rows['K8'][-1]['kernel_all_ms']:.3f} ms (kernels on all "
            "blocks, lists built beforehand)")
    pack_build_cost(large)
    cull_build_cost(scenes[-1][1])
    check_probes(rows)
    return rows


def reset_launches() -> None:
    from pathtracerpython_tpu_torch.kernels import intersect, nee, sparse, walker
    from pathtracerpython_tpu_torch.ops import gather, rng

    gather.LAUNCHES = rng.LAUNCHES = 0
    intersect.LAUNCHES = intersect.ANY_HIT_LAUNCHES = 0
    nee.LAUNCHES = sparse.LAUNCHES = walker.LAUNCHES = 0
    sparse.ANY_HIT_LAUNCHES = sparse.ANY_HIT_IDX_LAUNCHES = 0
    sparse.SELECT_LAUNCHES = 0
    walker.NEAREST_LAUNCHES = 0
    intersect.PLUCKER_LAUNCHES = intersect.PLUCKER_ANY_HIT_LAUNCHES = 0
    sparse.PLUCKER_LAUNCHES = sparse.PLUCKER_ANY_HIT_LAUNCHES = 0


def read_launches() -> dict:
    from pathtracerpython_tpu_torch.kernels import intersect, nee, sparse, walker
    from pathtracerpython_tpu_torch.ops import gather, rng

    return {"K1": intersect.LAUNCHES, "K2": nee.LAUNCHES,
            "K4": intersect.ANY_HIT_LAUNCHES, "K5": sparse.LAUNCHES,
            "K6": sparse.ANY_HIT_LAUNCHES, "K7": sparse.ANY_HIT_IDX_LAUNCHES,
            "K8": walker.NEAREST_LAUNCHES, "K9": walker.LAUNCHES,
            "K3 nearest": intersect.PLUCKER_LAUNCHES,
            "K3 any-hit": intersect.PLUCKER_ANY_HIT_LAUNCHES,
            "K3 sparse nearest": sparse.PLUCKER_LAUNCHES,
            "K3 sparse any-hit": sparse.PLUCKER_ANY_HIT_LAUNCHES,
            "two-pass select": sparse.SELECT_LAUNCHES,
            "scatter_rows": gather.LAUNCHES, "RNG": rng.LAUNCHES}


def rng_launches(cfg) -> int:
    """The RNG kernel's launches in a render of ``cfg`` on the card: two a
    bounce (the NEE and the scatter draws) of each sample pass, the samples
    one pass under batch_samples."""
    passes = 1 if cfg.batch_samples else cfg.n_samples
    return 2 * cfg.n_bounces * passes


def sweep_launches(launches: dict) -> dict:
    """The launches of the sweeps (every count but the backwards'
    ``scatter_rows`` and the RNG's) that were not zero."""
    return {k: v for k, v in launches.items()
            if v and k not in ("scatter_rows", "RNG")}


@contextlib.contextmanager
def two_pass_auto():
    """Both two-pass auto flags on, as scripts/bench_large.py turns them on
    in the JAX package (TWO_PASS_MIN stays: the 100k field's wavefronts
    are past it); restored after."""
    from pathtracerpython_tpu_torch.kernels import sparse

    before = sparse.TWO_PASS_NEAREST_AUTO, sparse.TWO_PASS_ANY_AUTO
    sparse.TWO_PASS_NEAREST_AUTO = sparse.TWO_PASS_ANY_AUTO = True
    try:
        yield
    finally:
        sparse.TWO_PASS_NEAREST_AUTO, sparse.TWO_PASS_ANY_AUTO = before


def two_pass_renders(large, large_cfg, variant_rad) -> dict:
    """The 100k field's sparse and hybrid renders with both auto flags on:
    the radiance of the default render of each bit for bit; each sweep with
    a two-pass form launches three times a bounce (pass 1, pass 2 and the
    fallback, the branch chosen on the device), the select-and-compact
    kernel once a bounce and sweep; then each against its default render
    in turns. Returns the launches of each."""
    from pathtracerpython_tpu_torch.render.integrator import render

    counts = {}
    for what, kw, sweeps, other in (
            ("accel='sparse'", dict(accel="sparse"), ("K5", "K6"), {}),
            ("accel='auto'", {}, ("K5",), {"K9": LARGE_BOUNCES})):
        label = f"100k box field, {what}, two-pass auto flags on"
        cfg = dataclasses.replace(large_cfg, **kw)
        with two_pass_auto():
            reset_launches()
            rad = render(large, cfg, seed=0)
            torch.cuda.synchronize()
            launches = read_launches()
        log(f"[3] {label}: launches {launches}")
        check_radiance(label, rad, CORNELL_SIZE * CORNELL_SIZE)
        diff = (rad - variant_rad[what]).abs().max().item()
        log(f"[3] {label} against the default render: max abs diff {diff:.3g}"
            f" ({'equal' if torch.equal(rad, variant_rad[what]) else 'not equal'})")
        if not torch.equal(rad, variant_rad[what]):
            fail(f"{label}: radiance differs from the default render (max "
                 f"abs diff {diff})")
        for key, n in launches.items():
            if key in sweeps:
                ok = n == 3 * LARGE_BOUNCES
            elif key == "two-pass select":
                ok = n == len(sweeps) * LARGE_BOUNCES
            elif key == "RNG":
                ok = n == rng_launches(cfg)
            else:
                ok = n == other.get(key, 0)
            if not ok:
                fail(f"{label}: {n} launches of {key}")
        counts[what] = launches
        seeds = iter(range(1000))
        one = lambda: render(large, cfg, seed=next(seeds))

        def two():
            with two_pass_auto():
                return render(large, cfg, seed=next(seeds))

        times = {one: [], two: []}
        for fn in (one, two):
            timed_runs(fn, warmup=2, reps=0)
        for fn in (one, two, two, one):
            times[fn] += timed_runs(fn, warmup=0, reps=5)
        log(f"[3] {label}, in turns with the default render: two-pass "
            f"{statistics.median(times[two]):.3f} ms/render (min "
            f"{min(times[two]):.3f}, max {max(times[two]):.3f}), one-pass "
            f"{statistics.median(times[one]):.3f} (min {min(times[one]):.3f},"
            f" max {max(times[one]):.3f}); medians of 10")
    return counts


def check_radiance(label, rad, pixels) -> None:
    if tuple(rad.shape) != (pixels, 3):
        fail(f"{label}: radiance shape {tuple(rad.shape)}")
    if not torch.isfinite(rad).all():
        fail(f"{label}: radiance has non-finite values")
    if (rad < 0).any():
        fail(f"{label}: radiance has negative values")
    if rad.min() == rad.max():
        fail(f"{label}: radiance is constant")
    log(f"[3] {label}: radiance finite, >= 0, mean {rad.mean().item():.6f}, "
        f"range [{rad.min().item():.6f}, {rad.max().item():.6f}]")


def render_counted(label, scene, cfg, want: dict) -> tuple:
    """Render once with every launch count set to 0 just before; fail
    unless the counts read just after are ``want``, with the RNG kernel's
    count replaced by ``rng_launches(cfg)``."""
    from pathtracerpython_tpu_torch.render.integrator import render

    want = {**want, "RNG": rng_launches(cfg)}
    reset_launches()
    rad = render(scene, cfg, seed=0)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[3] {label}: launches {launches}")
    if launches != want:
        fail(f"{label}: launches {launches}, expected {want}")
    return rad, launches


def hold_close(label, got, want) -> None:
    close = torch.isclose(got, want, rtol=RENDER_RTOL,
                          atol=RENDER_ATOL).all(dim=1)
    share = close.float().mean().item()
    diff = (got - want).abs().max().item()
    log(f"[3] {label}: {share:.4f} of pixels within rtol/atol "
        f"{RENDER_RTOL}, max abs diff {diff:.3g}")
    if share < MIN_PIXELS_CLOSE:
        fail(f"{label}: agree on only {share:.4f} of pixels")


def hold_population(label, got, want) -> None:
    """A Plücker render against the classic render of the same cell: the
    estimator and the random numbers are the same, only grazing winners
    differ, so the radiance differs on few pixels."""
    diff = (got - want).abs()
    mean = diff.mean().item()
    q999 = torch.quantile(diff.flatten(), 0.999).item()
    differing = (diff.amax(dim=1) > 0).float().mean().item()
    log(f"[3] {label}: mean abs diff {mean:.3g}, 99.9th percentile "
        f"{q999:.3g}, max {diff.max().item():.3g}, pixels that differ "
        f"{differing:.6f}")
    if mean >= POP_MEAN or q999 >= POP_Q999:
        fail(f"{label}: mean abs diff {mean} (limit {POP_MEAN}), 99.9th "
             f"percentile {q999} (limit {POP_Q999})")


def phase3_probes() -> dict:
    """The probes through their own entry points at their default sizes,
    with the launch counts set to 0 just before and read just after; their
    JSON lines are printed. P1's entry asserts its gate itself."""
    from pathtracerpython_tpu_torch.probes import bf16_probe, mma_probe

    launches = {}
    for key, module in (("P1", mma_probe), ("P2", bf16_probe)):
        for variant in module.VARIANTS:
            module.LAUNCHES[variant] = 0
        for row in module.run():
            log(f"[3] {key} " + json.dumps(row))
        for variant in module.VARIANTS:
            launches[f"{key} {variant}"] = module.LAUNCHES[variant]
    log(f"[3] probes: launches {launches}")
    return launches


def phase3_render(cornell, large, many) -> dict:
    """The main paths, each driven with the launch counts set to 0 just
    before it and read just after; returns each kernel's launches in its
    own path's run. ``many``: the 300-box field at MANY_NEE_SIZE."""
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import (
        box_field_scene,
        cornell_box_scene,
        grid_light,
    )

    # every count, the backwards' scatter_rows too: a render launches none
    none = dict.fromkeys(read_launches(), 0)
    cfg = RenderConfig(mode="fast", n_samples=CORNELL_SPP,
                       n_bounces=CORNELL_BOUNCES,
                       n_light_samples=NEE_SAMPLES, batch_samples=True)
    rad, cornell_counts = render_counted(
        f"Cornell stand-in {CORNELL_SIZE}x{CORNELL_SIZE}, {CORNELL_SPP} spp, "
        f"{CORNELL_BOUNCES} bounces", cornell, cfg,
        {**none, "K1": CORNELL_BOUNCES, "K2": CORNELL_BOUNCES})
    check_radiance("Cornell stand-in", rad, CORNELL_SIZE * CORNELL_SIZE)
    rng_with_plain_draws("Cornell stand-in", cornell, cfg, rad)
    plucker_counts = {}
    rad_p, plucker_counts["cornell"] = render_counted(
        "Cornell stand-in, mt_impl='plucker'", cornell,
        dataclasses.replace(cfg, mt_impl="plucker"),
        {**none, "K3 nearest": CORNELL_BOUNCES, "K2": CORNELL_BOUNCES})
    check_radiance("Cornell stand-in, mt_impl='plucker'", rad_p,
                   CORNELL_SIZE * CORNELL_SIZE)
    hold_population("Cornell stand-in, Plücker against classic", rad_p, rad)

    small_scene = pack_scene(cornell_box_scene(32, 32), pad_to=32,
                             device="cpu")
    small_cfg = RenderConfig(mode="fast", n_samples=2, n_bounces=4,
                             n_light_samples=NEE_SAMPLES, batch_samples=True)
    for what, c in (("", small_cfg),
                    (" mt_impl='plucker'",
                     dataclasses.replace(small_cfg, mt_impl="plucker"))):
        hold_close(f"Cornell 32x32x2spp{what} card vs CPU",
                   render(small_scene.to("cuda"), c, seed=0).cpu(),
                   render(small_scene, c, seed=0))

    large_cfg = RenderConfig(mode="fast", n_samples=LARGE_SPP,
                             n_bounces=LARGE_BOUNCES,
                             n_light_samples=NEE_SAMPLES, batch_samples=True)
    rad, large_counts = render_counted(
        f"100k box field {CORNELL_SIZE}x{CORNELL_SIZE}, {LARGE_SPP} spp, "
        f"{LARGE_BOUNCES} bounces, accel='auto'", large, large_cfg,
        {**none, "K5": LARGE_BOUNCES, "K9": LARGE_BOUNCES})
    log("[3] 100k box field: dense fallbacks 0 (K1, K2 and K4 launched "
        "0 times; the candidate lists have no cap, so no fallback path "
        "exists)")
    check_radiance("100k box field", rad, CORNELL_SIZE * CORNELL_SIZE)

    # the same render through the other hierarchies. K7 runs twice per
    # bounce, whatever the cache holds: pass 1 over the guess lists, then
    # pass 2 over the full lists (compacted or whole), and between them the
    # compact entry of the select-and-compact kernel once
    variant_counts, variant_rad = {"accel='auto'": large_counts}, {
        "accel='auto'": rad}
    for what, kw, want in (
        ("accel='sparse'", dict(accel="sparse"),
         {"K5": LARGE_BOUNCES, "K6": LARGE_BOUNCES}),
        ("accel='sparse', nee_cache='on'",
         dict(accel="sparse", nee_cache="on"),
         {"K5": LARGE_BOUNCES, "K7": 2 * LARGE_BOUNCES,
          "two-pass select": LARGE_BOUNCES}),
        ("accel='walker'", dict(accel="walker"),
         {"K8": LARGE_BOUNCES, "K9": LARGE_BOUNCES}),
    ):
        rad_v, variant_counts[what] = render_counted(
            f"100k box field, {what}", large,
            dataclasses.replace(large_cfg, **kw), {**none, **want})
        variant_rad[what] = rad_v
        check_radiance(f"100k box field, {what}", rad_v,
                       CORNELL_SIZE * CORNELL_SIZE)
        diff = (rad_v - rad).abs().max().item()
        log(f"[3] 100k box field, {what} against the hybrid render: max abs "
            f"diff {diff:.3g} ({'equal' if diff == 0 else 'not equal'})")
        if diff > VARIANT_ATOL:
            fail(f"100k box field, {what}: max abs diff {diff} from the "
                 f"hybrid render exceeds {VARIANT_ATOL}")

    # the same cells under the knob: the sparse hierarchy runs both of K3's
    # sparse sweeps; the hybrid its nearest sweep and the classic K9
    for what, kw, want in (
        ("accel='sparse'", dict(accel="sparse"),
         {"K3 sparse nearest": LARGE_BOUNCES,
          "K3 sparse any-hit": LARGE_BOUNCES}),
        ("accel='auto'", {},
         {"K3 sparse nearest": LARGE_BOUNCES, "K9": LARGE_BOUNCES}),
    ):
        label = f"100k box field, {what}, mt_impl='plucker'"
        rad_v, plucker_counts[what] = render_counted(
            label, large,
            dataclasses.replace(large_cfg, mt_impl="plucker", **kw),
            {**none, **want})
        check_radiance(label, rad_v, CORNELL_SIZE * CORNELL_SIZE)
        hold_population(f"100k box field, {what}, Plücker against classic",
                        rad_v, variant_rad[what])

    two_pass = two_pass_renders(large, large_cfg, variant_rad)

    size = HYBRID_CHECK_SIZE
    field = pack_scene(box_field_scene(n_boxes=FIELD_BOXES, width=size,
                                       height=size))
    field_cfg = RenderConfig(mode="fast", n_samples=FIELD_SPP,
                             n_bounces=FIELD_BOUNCES,
                             n_light_samples=NEE_SAMPLES, batch_samples=True)
    hybrid, _ = render_counted(
        f"box field {FIELD_BOXES} {size}x{size} accel='hybrid'", field,
        dataclasses.replace(field_cfg, accel="hybrid"),
        {**none, "K5": FIELD_BOUNCES, "K9": FIELD_BOUNCES})
    dense, _ = render_counted(
        f"box field {FIELD_BOXES} {size}x{size} accel='none'", field,
        dataclasses.replace(field_cfg, accel="none"),
        {**none, "K1": FIELD_BOUNCES, "K2": FIELD_BOUNCES})
    hold_close(f"box field {FIELD_BOXES} {size}x{size} hybrid vs none on "
               "the card", hybrid, dense)

    small_field = pack_scene(box_field_scene(n_boxes=400, width=32,
                                             height=32), tri_order="morton",
                             device="cpu")
    for what, kw in (("hybrid", dict(accel="hybrid")),
                     ("sparse with the cache",
                      dict(accel="sparse", nee_cache="on")),
                     ("walker", dict(accel="walker")),
                     ("sparse mt_impl='plucker'",
                      dict(accel="sparse", mt_impl="plucker")),
                     ("hybrid mt_impl='plucker'",
                      dict(accel="hybrid", mt_impl="plucker"))):
        field_cfg_v = dataclasses.replace(small_cfg, n_bounces=3, **kw)
        hold_close(f"box field 400 32x32x2spp {what} card vs CPU",
                   render(small_field.to("cuda"), field_cfg_v, seed=0).cpu(),
                   render(small_field, field_cfg_v, seed=0))

    big_light = pack_scene(dataclasses.replace(
        cornell_box_scene(64, 64),
        light_mesh=grid_light(6, 6, 3.0, -0.45, 0.45, -24.3, -22.5),
    ), pad_to=32)
    rad, light_counts = render_counted(
        f"Cornell stand-in 64x64 with a "
        f"{big_light.meta.n_light_triangles}-triangle light (unfused NEE)",
        big_light, dataclasses.replace(cfg, n_samples=1),
        {**none, "K1": CORNELL_BOUNCES, "K4": CORNELL_BOUNCES})
    check_radiance("72-triangle light", rad, 64 * 64)
    rad_p, plucker_counts["light"] = render_counted(
        "Cornell stand-in 64x64 with the 72-triangle light, "
        "mt_impl='plucker'", big_light,
        dataclasses.replace(cfg, n_samples=1, mt_impl="plucker"),
        {**none, "K3 nearest": CORNELL_BOUNCES,
         "K3 any-hit": CORNELL_BOUNCES})
    check_radiance("72-triangle light, mt_impl='plucker'", rad_p, 64 * 64)
    hold_population("72-triangle light, Plücker against classic", rad_p, rad)

    many_cfg = RenderConfig(mode="fast", n_samples=MANY_NEE_SPP,
                            n_bounces=MANY_NEE_BOUNCES,
                            n_light_samples=MANY_NEE_SAMPLES,
                            batch_samples=True)
    many_label = (f"box field {FIELD_BOXES} with {MANY_NEE_SAMPLES} NEE "
                  "samples (unfused NEE)")
    rad, many_counts = render_counted(
        f"{many_label} {MANY_NEE_SIZE}x{MANY_NEE_SIZE}, {MANY_NEE_SPP} spp, "
        f"{MANY_NEE_BOUNCES} bounces", many,
        many_cfg, {**none, "K1": MANY_NEE_BOUNCES, "K4": MANY_NEE_BOUNCES})
    check_radiance(many_label, rad, MANY_NEE_SIZE * MANY_NEE_SIZE)
    small_many = pack_scene(box_field_scene(n_boxes=FIELD_BOXES, width=32,
                                            height=32), device="cpu")
    hold_close(f"{many_label} 32x32 card vs CPU",
               render(small_many.to("cuda"), many_cfg, seed=0).cpu(),
               render(small_many, many_cfg, seed=0))
    return {"K3 nearest": plucker_counts["cornell"]["K3 nearest"],
            "K3 any-hit": plucker_counts["light"]["K3 any-hit"],
            "K3 sparse nearest":
                plucker_counts["accel='sparse'"]["K3 sparse nearest"],
            "K3 sparse any-hit":
                plucker_counts["accel='sparse'"]["K3 sparse any-hit"],
            "K1": cornell_counts["K1"], "K2": cornell_counts["K2"],
            "RNG": cornell_counts["RNG"], "K4": many_counts["K4"],
            "K5": large_counts["K5"],
            "K6": variant_counts["accel='sparse'"]["K6"],
            "K7": variant_counts["accel='sparse', nee_cache='on'"]["K7"],
            "K8": variant_counts["accel='walker'"]["K8"],
            "K9": large_counts["K9"],
            "K5 two-pass": two_pass["accel='auto'"]["K5"],
            "K5@512 two-pass": two_pass["accel='sparse'"]["K5"],
            "K6 two-pass": two_pass["accel='sparse'"]["K6"],
            "two-pass select": variant_counts[
                "accel='sparse', nee_cache='on'"]["two-pass select"],
            "two-pass select, two-pass auto flags": two_pass[
                "accel='sparse'"]["two-pass select"]}


# The gradient phase: the fit_albedo slice and the backwards. Card against
# CPU: the same params, target and key, the kernels against their plain
# versions; the card's rsqrt, sin, cos and its summation order (the
# scatter_rows kernel's fixed tree against the CPU's serial bincount) round
# differently, so each field's gradient may differ in the last bits, and a
# grazing ray that flips a winner would move a field by far more. Relative
# L2 per field.
FIT_STEPS = 10    # of apps/fit_albedo.py, at its own configuration
GRAD_RTOL = 1e-4
GRAD_FIELDS = ("mat_rgb", "light_color", "ambient", "tri_v0", "light_v0",
               "eye", "ortho")
# the training step of the bench configuration (the Cornell cell)
STEP_FIELDS = ("mat_rgb", "mat_ka", "mat_kd", "light_color", "ambient",
               "tri_v0", "tri_v1", "tri_v2", "light_v0", "light_v1",
               "light_v2")
HIER_SIZE = 128   # the 100k field's hierarchy gradients
NEAREST_BACKWARD = ("NearestTIdx.backward: intersect.nearest_bwd, each "
                    "winner re-solved with ops/geometry.py:intersect_moller "
                    "in plain PyTorch")
NEE_BACKWARD = ("NeeMeanCos.backward: nee.smooth_mean_cos recomputed in "
                "plain PyTorch, occlusion fixed")
NO_BACKWARD = "none (detached)"
# The table gradients' sum, ops/gather.py:scatter_rows: on the card
# csrc/scatter_rows.cu (narrow tables with no sort, each thread's or each
# warp's lanes in lane order, then fixed trees; wide tables a stable sort,
# then runs of equal keys in windows of 32 sorted positions; an order fixed
# by the inputs either way). No TPU kernel: in the JAX package it is XLA's
# scatter-add, the transpose of a gather. Its phase-2 rows are the calls
# the bench step's backward makes, captured from one backward, the 100k
# field's tri_v0 backward on its primary rays, and 2^20 x 9 lanes onto
# each side of the kernel's two limits (gather.plan: tiny up to 32 table
# entries, narrow up to 1024, wide past it).
SCATTER_REL_TOL = 1e-6   # of the float64 sum, relative to the absolute sum
SCATTER_RUNS = 3         # runs of a gradient that must give the same bits
SCATTER_BACKWARD = "none (it is the backwards' sum)"
SCATTER_EDGE_ROWS = (3, 4, 113, 114)   # x 9 columns: 27 | 36, 1017 | 1026
# path -> one audited backward's report: the float sums whose lanes met at
# one address (a gate: there must be none) or not, and the ops that
# torch.use_deterministic_algorithms(True, warn_only=True) warned of
AUDIT = {}


def determinism_audit(label: str, fn) -> dict:
    """Run ``fn()`` (a forward and its backward) once as a check-only pass:
    under ``utils.determinism.SumAudit`` and anomaly mode (which names the
    forward line of each backward node), with
    ``torch.use_deterministic_algorithms(True, warn_only=True)`` set for the
    pass alone (and uninitialized memory left unfilled). Records the report
    in AUDIT; fails if a float sum met two lanes at one address, or if the
    mode saw no backward op."""
    import warnings

    from pathtracerpython_tpu_torch.utils.determinism import SumAudit

    def flagged(caught) -> list:
        return sorted({str(w.message).split(". ")[0][:160] for w in caught
                       if "determinis" in str(w.message)})

    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.utils.deterministic.fill_uninitialized_memory = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        # the control: a weighted bincount on the card, which the mode
        # must flag, so that an empty list below means what it says
        with warnings.catch_warnings(record=True) as control:
            warnings.simplefilter("always")
            torch.bincount(torch.zeros(1, dtype=torch.int64, device="cuda"),
                           weights=torch.ones(1, device="cuda"))
        with warnings.catch_warnings(record=True) as caught, \
                torch.autograd.detect_anomaly(check_nan=False), \
                SumAudit() as audit:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = fill
    if not flagged(control):
        fail("the deterministic mode's warnings are not caught: a weighted "
             "bincount on the card was not flagged")
    row = {**audit.report(), "flagged_by_torch": flagged(caught)}
    AUDIT[label] = row
    log(f"[audit] {label}: float sums meeting at one address "
        f"{row['shared']}; with distinct addresses {row['unique']}; flagged "
        f"by torch's deterministic mode {row['flagged_by_torch']}; "
        f"{row['ops']} ops seen, "
        f"{row['backward_ops']} in the backward")
    if audit.backward_ops == 0:
        fail(f"audit of {label}: the dispatch mode saw no backward op")
    if audit.shared:
        fail(f"audit of {label}: float sums add lanes into one address in "
             f"an order the device chooses: {row['shared']}")
    return row


def hold_bits_equal(label: str, runs: list) -> None:
    """Fail unless every run's gradients (dicts of tensors) equal the first
    run's bit for bit."""
    for i, run in enumerate(runs[1:], start=2):
        differ = [k for k in runs[0] if not torch.equal(run[k], runs[0][k])]
        if differ:
            fail(f"{label}: run {i}'s gradients of {differ} differ from run "
                 "1's bits")
    log(f"[bits] {label}: gradients bit-equal over {len(runs)} runs "
        f"({sorted(runs[0])})")


def capture_scatters(fn) -> list[dict]:
    """Run ``fn()`` with each caller of ``scatter_rows`` (ops/gather.py's
    gathers, kernels/intersect.py's nearest_bwd, kernels/nee.py's
    NeeMeanCos) recording a copy of its inputs, strides kept, in call
    order."""
    from pathtracerpython_tpu_torch.kernels import intersect, nee
    from pathtracerpython_tpu_torch.ops import gather

    calls = []
    callers = ((gather, "cm_take"), (intersect, "nearest_bwd"),
               (nee, "NeeMeanCos"))
    saved = {module: module.scatter_rows for module, _ in callers}

    def recording(caller, real):
        def record(values, rows, n_rows):
            calls.append({"caller": caller, "values": values.detach().clone(),
                          "rows": rows.detach().clone(), "n_rows": n_rows})
            return real(values, rows, n_rows)
        return record

    for module, caller in callers:
        module.scatter_rows = recording(caller, saved[module])
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for module, real in saved.items():
            module.scatter_rows = real
    return calls


def check_scatter(label: str, call: dict, report: list) -> None:
    """csrc/scatter_rows.cu on one captured call: its order's model
    (``gather.scatter_rows_model``) bit for bit; the same bits in
    SCATTER_RUNS launches and on a second stream; no stream sync in the
    call (sync debug mode "error"); within SCATTER_REL_TOL of the float64
    sum and of its plain version, relative to the absolute sum; and the
    times (CUDA events, mean of 10, the calls queued behind a spin:
    ``cuda_ms(..., queued=True)``) of the kernel (its path from
    ``gather.plan``), and its call unqueued, its plain version (a float64 bincount rounded once),
    the float32 weighted bincount the backwards used before (the library
    call), index_add_ into a zero table and a stable sort of the rows
    alone (which only the wide path runs). Bound: the values, the rows and
    the table once over the memory rate."""
    from pathtracerpython_tpu_torch.ops import gather

    v, r, n_rows = call["values"], call["rows"], call["n_rows"]
    n, c = v.shape
    path = gather.plan(n, c, n_rows)[0]
    got = gather.scatter_rows(v, r, n_rows)
    if not torch.equal(got, gather.scatter_rows_model(v, r, n_rows)):
        fail(f"scatter_rows {label}: the kernel differs from its order's "
             "model")
    runs = [gather.scatter_rows(v, r, n_rows)
            for _ in range(SCATTER_RUNS - 1)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        runs.append(gather.scatter_rows(v, r, n_rows))
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if not all(torch.equal(x, got) for x in runs):
        fail(f"scatter_rows {label}: launches give different bits")
    torch.cuda.set_sync_debug_mode("error")
    try:
        gather.scatter_rows(v, r, n_rows)
    except RuntimeError as e:
        fail(f"scatter_rows {label}: the call synchronised: {e}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    exact = torch.zeros((n_rows, c), dtype=torch.float64,
                        device="cuda").index_add_(0, r, v.double())
    scale = torch.zeros_like(exact).index_add_(0, r, v.double().abs())

    def rel(x):
        return float(((x.double() - exact).abs()
                      / scale.clamp_min(1e-30)).max())

    plain = gather.scatter_rows_plain(v, r, n_rows)
    bins = (r[:, None] * c + torch.arange(c, device="cuda")).reshape(-1)
    flat = v.reshape(-1)

    def bincount32():   # the function as it stood: float32 atomics
        return torch.bincount(bins, weights=flat, minlength=n_rows * c)

    k_rel, p_rel = rel(got), rel(plain)
    b_rel = rel(bincount32().reshape(n_rows, c))
    against_plain = float(((got.double() - plain.double()).abs()
                           / scale.clamp_min(1e-30)).max())
    if not (k_rel <= SCATTER_REL_TOL and against_plain <= SCATTER_REL_TOL):
        fail(f"scatter_rows {label}: {k_rel} of the absolute sum from the "
             f"float64 sum, {against_plain} from the plain version; bound "
             f"{SCATTER_REL_TOL}")
    ms = cuda_ms(lambda: gather.scatter_rows(v, r, n_rows), 10, queued=True)
    call_ms = cuda_ms(lambda: gather.scatter_rows(v, r, n_rows), 10)
    plain_ms = cuda_ms(lambda: gather.scatter_rows_plain(v, r, n_rows), 10,
                       queued=True)
    bincount_ms = cuda_ms(bincount32, 10, queued=True)
    index_add_ms = cuda_ms(lambda: torch.zeros(
        (n_rows, c), device="cuda").index_add_(0, r, v), 10, queued=True)
    sort_ms = cuda_ms(lambda: torch.sort(r.to(torch.int32), stable=True), 10,
                      queued=True)
    nbytes = n * c * v.element_size() + tensor_bytes(r) + n_rows * c * 4
    row = report_row(label, float((got - plain).abs().max()), ms, plain_ms,
                     bound(nbytes, 0, 0), library_ms=bincount_ms,
                     index_add_ms=index_add_ms, sort_ms=sort_ms,
                     call_ms=call_ms, lanes=n,
                     cols=c, n_rows=n_rows, path=path, caller=call["caller"],
                     contiguous=v.is_contiguous(), kernel_rel_err=k_rel,
                     kernel_plain_rel_err=against_plain, plain_rel_err=p_rel,
                     bincount32_rel_err=b_rel)
    report.append(row)
    layout = "contiguous" if v.is_contiguous() else "strided"
    log(f"[2] scatter_rows {label}: {n} lanes x {c} onto {n_rows} rows "
        f"({call['caller']}, {layout}, {path} path): kernel / plain / "
        f"float32 bincount / index_add_ / bound {ms:.4f} / {plain_ms:.4f} / "
        f"{bincount_ms:.4f} / {index_add_ms:.4f} / {row['bound_ms']:.4f} ms "
        f"(bytes; a stable sort of the rows alone {sort_ms:.4f}; each timed "
        f"queued behind a spin, and the kernel's call unqueued "
        f"{call_ms:.4f}); the "
        f"model's bits, {SCATTER_RUNS + 1} launches bit-equal (one on a "
        f"second stream), no sync; of the absolute sum, {k_rel:.3g} from "
        f"float64 and {against_plain:.3g} from the plain version (the float32"
        f" bincount {b_rel:.3g} from float64)")


def bench_step_grads(cornell):
    """The training step of the bench configuration (Cornell 512^2, 4 spp
    as lanes, 4 bounces, 3 NEE, STEP_FIELDS, mat_rgb at half the truth):
    ``grads(key)``, one forward and backward from fresh leaves -> {field:
    grad}."""
    from pathtracerpython_tpu_torch.diff import (
        camera_pixel_loss,
        make_render_fn,
    )
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render

    cfg = RenderConfig(mode="fast", n_samples=CORNELL_SPP,
                       n_bounces=CORNELL_BOUNCES,
                       n_light_samples=NEE_SAMPLES, batch_samples=True)
    with torch.no_grad():
        target = render(cornell, cfg, seed=0)
    start = {f: getattr(cornell, f).detach().clone() for f in STEP_FIELDS}
    start["mat_rgb"] = start["mat_rgb"] * 0.5
    pids = torch.arange(target.shape[0], device="cuda")
    render_fn = make_render_fn(cfg)

    def grads(key) -> dict:
        params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
        camera_pixel_loss(params, cornell, target, render_fn, pids,
                          key).backward()
        return {k: p.grad for k, p in params.items()}

    return grads


def phase2_scatter(cornell, large) -> list:
    """csrc/scatter_rows.cu on the inputs the main path gives it: the bench
    step's backward's calls for the triangle pack (nearest_bwd: 2^20 lanes x 9
    onto 64 rows), the light table (NeeMeanCos: 3 x 2^20 x 9 onto 2) and
    mat_rgb (cm_take: 2^20 x 3, strided, onto the materials), the 100k
    field's tri_v0 backward (K5 under NearestTIdx on its 512^2 primary
    rays: 262,144 x 9 onto 100,096 rows), and 2^20 x 9 lanes from a seed
    onto SCATTER_EDGE_ROWS rows, the two sides of the tiny and of the
    narrow path's limits."""
    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
    from pathtracerpython_tpu_torch.ops.geometry import (
        nearest_hit_cm,
        normalize3,
    )

    grads = bench_step_grads(cornell)
    calls = capture_scatters(lambda: grads((0, 5)))
    o, d = make_primary_rays(large.eye, large.ortho, CORNELL_SIZE,
                             CORNELL_SIZE)
    o3, d3u = o.T.contiguous(), normalize3(d.T).contiguous()

    def tri_backward():
        leaves = {f: getattr(large, f).detach().clone().requires_grad_(True)
                  for f in ("tri_v0", "tri_v1", "tri_v2")}
        t = nearest_hit_cm(o3, d3u, dataclasses.replace(large, **leaves),
                           accel="auto").t
        gen = torch.Generator(device="cuda").manual_seed(3)
        t.backward(torch.randn(t.shape[0], generator=gen, device="cuda"))

    calls += capture_scatters(tri_backward)

    def pick(caller, c=None, n_rows=None):
        for call in calls:
            if (call["caller"] == caller
                    and c in (None, call["values"].shape[1])
                    and n_rows in (None, call["n_rows"])):
                return call
        seen = [(x["caller"], tuple(x["values"].shape), x["n_rows"])
                for x in calls]
        fail(f"phase 2: no call of scatter_rows from {caller} with {c} "
             f"columns onto {n_rows} rows: {seen}")

    report = []
    for label, call in (
            ("bench step pack", pick("nearest_bwd", 9,
                                     cornell.num_padded_triangles)),
            ("bench step light table", pick("NeeMeanCos")),
            ("bench step mat_rgb", pick("cm_take", 3,
                                        cornell.mat_rgb.shape[0])),
            ("100k field tri_v0", pick("nearest_bwd", 9,
                                       large.num_padded_triangles))):
        check_scatter(label, call, report)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for n_rows in SCATTER_EDGE_ROWS:
        u = torch.rand(2**20, generator=gen, device="cuda")
        check_scatter(f"edge onto {n_rows} rows", {
            "caller": "seeded", "n_rows": n_rows,
            "values": torch.randn((2**20, 9), generator=gen, device="cuda"),
            "rows": (u * u * n_rows).to(torch.int64).clamp_max(n_rows - 1)},
            report)
    paths = {row["path"] for row in report}
    if paths != {"tiny", "narrow", "wide"}:
        fail(f"phase 2: scatter_rows' rows took the paths {paths}, not all "
             "three")
    return report


# The RNG kernel (csrc/threefry.cu) at the main path's shapes: the lanes of
# one 16-spp chunk of the 512x512 render (the benchmark's cells), the path
# counters int64 as RayState holds them, and a bounce's two draws at 3 NEE
# samples: 5 x 3 for the NEE, 3 for the scatter.
RNG_LANES = 512 * 512 * 16
RNG_SPP = 16
RNG_DRAWS = (5 * NEE_SAMPLES, 3)
# The card's ceiling on 32-bit integer operations: each of an SM's 4
# schedulers dispatches one warp instruction a clock, 128 lanes a clock an
# SM, at the clock of the data sheet's float32 peak (128 FP32 lanes an SM, a
# fused multiply-add counted as two): half of PEAK_FP32_FLOPS, 33.5 T a
# second. The white paper's 64 INT32 lanes an SM (16.75 T) are no ceiling:
# the compiler emits adds as IMAD on the float pipe beside the integer
# pipe's shifts and logic, and csrc/threefry.cu ran 15 draws over
# RNG_LANES in 0.133 ms on an H100 SXM (700 W), under the 0.156 ms that
# rate would allow.
PEAK_INT32_OPS = PEAK_FP32_FLOPS / 2
# uint32 operations of one Threefry-2x32 hash (csrc/threefry.cu): 2 key
# adds, 20 rounds of an add, a rotate and an xor, 5 key injections of 2
# adds; and of one draw's conversion to [0, 1): a shift, an or, a subtract
THREEFRY_OPS_PER_HASH = 72
UNIT_OPS_PER_DRAW = 3


def phase2_rng() -> list:
    """csrc/threefry.cu (``ops/rng.py:uniforms`` on the card) on RNG_LANES
    int64 path counters (pixel id x RNG_SPP + sample, as a chunk's lanes
    hold them) for each of RNG_DRAWS: bit for bit the plain version
    (``uniforms_plain``), one launch a call; the kernel's ms (CUDA events,
    mean of 10, queued behind a spin), the plain version's (mean of 3) and
    the bound: the counters read once and the draws written once over the
    memory rate, or the hashes' and conversions' integer operations over
    PEAK_INT32_OPS, the larger. Returns the rows; phase 3 holds the Cornell
    render with the kernel to the render with the plain draws."""
    from pathtracerpython_tpu_torch.ops import rng

    pid = torch.arange(RNG_LANES // RNG_SPP, dtype=torch.int64, device="cuda")
    counters = torch.cat([pid * RNG_SPP + s for s in range(RNG_SPP)])
    k0, k1 = rng.fold(*rng.key_from_seed(2**40 + 12345), 4 + 1)
    rows = []
    for n_draws in RNG_DRAWS:
        label = f"{RNG_LANES} int64 counters x {n_draws} draws"
        before = rng.LAUNCHES
        got = rng.uniforms(k0, k1, counters, n_draws)
        want = rng.uniforms_plain(k0, k1, counters, n_draws)
        torch.cuda.synchronize()
        if rng.LAUNCHES != before + 1:
            fail(f"rng {label}: {rng.LAUNCHES - before} launches in one call")
        differ = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        err = (got - want).abs().max().item()
        if differ:
            fail(f"rng {label}: {differ} draws differ from the plain "
                 f"version's bits (max abs diff {err})")
        ms = cuda_ms(lambda: rng.uniforms_cuda(k0, k1, counters, n_draws), 10,
                     queued=True)
        plain_ms = cuda_ms(
            lambda: rng.uniforms_plain(k0, k1, counters, n_draws), 3)
        n = counters.numel()
        hashes = (n_draws + 1) // 2
        int_ops = n * (hashes * THREEFRY_OPS_PER_HASH
                       + n_draws * UNIT_OPS_PER_DRAW)
        nbytes = tensor_bytes(counters) + n * n_draws * 4
        row = report_row(label, err, ms, plain_ms,
                         bound_ops(nbytes, int_ops / PEAK_INT32_OPS * 1e3),
                         lanes=n, draws=n_draws, hashes=hashes,
                         int_ops=int_ops, bytes=nbytes,
                         launches=rng.LAUNCHES - before)
        rows.append(row)
        log(f"[2] rng {label}: kernel / plain / bound {ms:.4f} / "
            f"{plain_ms:.4f} / {row['bound_ms']:.4f} ms (bound by "
            f"{row['bound_by']}: {nbytes} bytes at {PEAK_BYTES_PER_S:.3g} "
            f"B/s, {int_ops} integer operations at {PEAK_INT32_OPS:.4g}/s, "
            "half the data sheet's float32 peak); max abs diff to the plain "
            f"version {err}; {row['launches']} launches, one a call")
    return rows


def rng_with_plain_draws(label, scene, cfg, rad) -> None:
    """``scene`` rendered again as ``render_counted`` rendered it (seed 0)
    with ``rng.uniforms`` patched to the plain version: the radiance must
    be ``rad`` bit for bit."""
    from pathtracerpython_tpu_torch.ops import rng
    from pathtracerpython_tpu_torch.render.integrator import render

    real = rng.uniforms
    rng.uniforms = rng.uniforms_plain
    try:
        plain = render(scene, cfg, seed=0)
    finally:
        rng.uniforms = real
    diff = (rad - plain).abs().max().item()
    if not torch.equal(rad, plain):
        fail(f"{label}: the render with the RNG kernel differs from the "
             f"render with the plain draws (max abs diff {diff})")
    log(f"[3] {label}: the render with the RNG kernel equals the render "
        "with the plain draws bit for bit")


def rng_kernel_entry(rng_rows: list, launches: int) -> dict:
    """The kernels line's entry of csrc/threefry.cu: its first row (a
    bounce's NEE draws), the other beside it; ``launches``: those of
    phase 3's Cornell render."""
    first, *rest = rng_rows
    return {
        "name": "rng ops/rng.py:uniforms", "route": "cuda",
        "source": "pathtracerpython_tpu_torch/csrc/threefry.cu",
        "replaces": "none: the JAX package's ops/rng.py is plain jnp",
        "tpu_kernel": "none: jnp in the JAX package's ops/rng.py",
        "launches": launches,
        "max_abs_err": max(r["err"] for r in rng_rows),
        "ms": first["ms"], "plain_ms": first["plain_ms"],
        "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
        "library_ms": None, "backward": "none (the draws carry no gradient)",
        **{k: first[k] for k in ("lanes", "draws", "int_ops", "bytes")},
        "int32_peak_ops_per_s": PEAK_INT32_OPS,
        "other_shapes": [{k: r[k] for k in ("label", "ms", "plain_ms",
                                            "bound_ms", "bound_by")}
                         for r in rest],
    }


def backward_syncs(loss_fn) -> int:
    """The stream syncs of one backward of ``loss_fn()``, as the sync debug
    mode "warn" reports them (the forward runs before the mode is set)."""
    import warnings

    loss = loss_fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            loss.backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in caught)


@contextlib.contextmanager
def bincount_backwards():
    """Every caller of ``scatter_rows`` on the weighted bincount (the plain
    version, as the backwards summed before the kernel), restored after."""
    from pathtracerpython_tpu_torch.kernels import intersect, nee
    from pathtracerpython_tpu_torch.ops import gather

    saved = {m: m.scatter_rows for m in (gather, intersect, nee)}
    for m in saved:
        m.scatter_rows = gather.scatter_rows_plain
    try:
        yield
    finally:
        for m, real in saved.items():
            m.scatter_rows = real


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    scale = want.norm().item()
    return (got - want).norm().item() / scale if scale > 0 else (
        got.norm().item())


def camera_grads(scene, cfg, params: dict, target, key) -> tuple:
    """(loss, {field: grad}) of ``camera_pixel_loss`` at ``params``."""
    from pathtracerpython_tpu_torch.diff import (
        camera_pixel_loss,
        make_render_fn,
    )

    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    pids = torch.arange(scene.meta.width * scene.meta.height,
                        device=scene.device)
    loss = camera_pixel_loss(leaves, scene, target, make_render_fn(cfg),
                             pids, key)
    loss.backward()
    return loss.item(), {k: v.grad for k, v in leaves.items()}


def hold_grads(label, got: dict, want: dict, bound_: float) -> dict:
    errs = {k: rel_l2(got[k], want[k]) for k in want}
    for k, g in got.items():
        if not torch.isfinite(g).all():
            fail(f"{label}: the gradient of {k} is not finite")
    log(f"[3g] {label}: relative L2 per field " + json.dumps(errs))
    worst = max(errs, key=errs.get)
    if errs[worst] > bound_:
        fail(f"{label}: {worst} differs by {errs[worst]} (relative L2), "
             f"bound {bound_}")
    return errs


def grad_fit_slice(card: str) -> dict:
    """The slice through its entry point: ``apps.fit_albedo.run`` on the
    card for FIT_STEPS steps, with the launch counts set to 0 just before
    and read just after; the loss must fall."""
    import tempfile

    from pathtracerpython_tpu_torch.apps import fit_albedo

    with tempfile.TemporaryDirectory() as out:
        reset_launches()
        t0 = time.perf_counter()
        result = fit_albedo.run(steps=FIT_STEPS, out_dir=out, log=log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        with open(os.path.join(out, "result.json")) as f:
            losses = json.load(f)["losses"]
    log(f"[3g] fit_albedo {FIT_STEPS} steps on {result['device']} ({card}): "
        f"losses {losses}; {wall:.3f} s wall with its two renders; "
        f"launches {launches}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"fit_albedo: the loss did not fall: {losses}")
    # one launch per sample pass and bounce of each step and of the target
    # and fitted renders (the RNG two); the backwards launch none
    want = fit_albedo.SPP * fit_albedo.BOUNCES * (FIT_STEPS + 2)
    if launches["K1"] != want or launches["K2"] != want \
            or launches["RNG"] != 2 * want:
        fail(f"fit_albedo: K1 {launches['K1']}, K2 {launches['K2']} and RNG "
             f"{launches['RNG']} launches, expected {want}, {want} and "
             f"{2 * want}")
    return {"losses": losses, "launches": launches,
            "max_albedo_err": result["max_albedo_err"],
            "scene": result["scene"]}



def grad_card_vs_cpu() -> dict:
    """Step 0 of the fit_albedo configuration: the gradients of GRAD_FIELDS
    on the card and with the plain versions on the CPU."""
    from pathtracerpython_tpu_torch.apps import fit_albedo
    from pathtracerpython_tpu_torch.ops import rng
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render

    scene, what = fit_albedo.load_fit_scene(None, "cuda")
    cfg = RenderConfig(mode="fast", n_samples=fit_albedo.SPP,
                       n_bounces=fit_albedo.BOUNCES,
                       n_light_samples=fit_albedo.NEE_SAMPLES)
    with torch.no_grad():
        target = render(scene, cfg, seed=0)
    params = {f: getattr(scene, f) for f in GRAD_FIELDS}
    params["mat_rgb"] = scene.mat_rgb * 0.25
    params["light_color"] = scene.light_color * 2.0
    key = rng.split(0)[1]  # fit's first step
    loss_c, got = camera_grads(scene, cfg, params, target, key)
    cpu = scene.to("cpu")
    loss_h, want = camera_grads(cpu, cfg, {k: v.cpu() for k, v in
                                           params.items()},
                                target.cpu(), key)
    log(f"[3g] step 0 of fit_albedo ({what}): loss "
        f"{loss_c!r} on the card, {loss_h!r} on the CPU")
    errs = hold_grads("card against CPU, step 0", got, want, GRAD_RTOL)
    return {"loss_card": loss_c, "loss_cpu": loss_h, "rel_l2": errs}


def grad_forward_bits(cornell, card: str) -> dict:
    """K1 under NearestTIdx and K2 under NeeMeanCos give the no-grad call's
    bits, on the Cornell camera's 512^2 primary rays; and the backwards
    timed alone there (CUDA events, mean of 20 after 3 warm-ups)."""
    import dataclasses as dc

    from pathtracerpython_tpu_torch.kernels import intersect, nee
    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
    from pathtracerpython_tpu_torch.ops.gather import cm_take
    from pathtracerpython_tpu_torch.ops.geometry import normalize3
    from pathtracerpython_tpu_torch.render.integrator import (
        arrival_side_normal,
    )

    w = cornell.meta.width
    o, d = make_primary_rays(cornell.eye, cornell.ortho, w, w)
    o3 = o.T.repeat(1, CORNELL_SPP).contiguous()
    d3 = normalize3(d.T.repeat(1, CORNELL_SPP)).contiguous()
    n = o3.shape[1]
    t0, i0 = intersect.nearest_t_idx_cm(o3, d3, cornell)
    o3g = o3.clone().requires_grad_(True)
    leaves = {f: getattr(cornell, f).clone().requires_grad_(True)
              for f in ("tri_v0", "tri_v1", "tri_v2", "light_v0", "light_v1",
                        "light_v2")}
    sc = dc.replace(cornell, **leaves)
    reset_launches()
    t1, i1 = intersect.nearest_t_idx_cm(o3g, d3, sc)
    k1 = read_launches()["K1"]
    if not (torch.equal(t1.detach(), t0) and torch.equal(i1, i0)):
        fail("K1 under NearestTIdx: t or idx differ from the no-grad call")
    point3 = (o3 + d3 * t0[None]).contiguous()
    normal3 = arrival_side_normal(
        cm_take(cornell.tri_normal.T, i0.clamp_min(0).to(torch.int64)),
        d3).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(0)
    u = torch.rand((5 * NEE_SAMPLES, n), generator=gen, device="cuda")
    mc0, occ0 = nee.nee_mean_cos_fused(point3, normal3, u, cornell,
                                       NEE_SAMPLES)
    p3g = point3.clone().requires_grad_(True)
    n3g = normal3.clone().requires_grad_(True)
    reset_launches()
    mc1, occ1 = nee.nee_mean_cos_fused(p3g, n3g, u, sc, NEE_SAMPLES)
    k2 = read_launches()["K2"]
    if not (torch.equal(mc1.detach(), mc0) and torch.equal(occ1, occ0)):
        fail("K2 under NeeMeanCos: mc or occ differ from the no-grad call")
    log(f"[3g] K1 under NearestTIdx and K2 under NeeMeanCos on {n} lanes: "
        f"t, idx, mc and occ bit-equal to the no-grad calls ({k1} K1 and "
        f"{k2} K2 launch, the forwards only)")
    g = torch.randn((1, n), generator=gen, device="cuda")
    nee_in = [p3g, n3g, *(leaves[f] for f in ("light_v0", "light_v1",
                                              "light_v2"))]

    def nee_bwd():
        torch.autograd.grad(mc1, nee_in, g, retain_graph=True)

    for _ in range(3):
        nee_bwd()
    times = {
        "nearest": nearest_backward_ms(
            "K1", lambda o, sc: intersect.nearest_t_idx_cm(o, d3, sc)[0],
            o3, cornell),
        "nearest plucker": nearest_backward_ms(
            "K3 nearest", lambda o, sc: intersect.nearest_t_idx_cm(
                o, d3, sc, mt_impl="plucker")[0], o3, cornell),
        "nee": cuda_ms(nee_bwd, 20)}
    log(f"[3g] backwards alone on the {n}-lane wavefront ({card}): "
        f"NearestTIdx {times['nearest']:.4f} ms under K1, "
        f"{times['nearest plucker']:.4f} ms under K3's dense nearest, "
        f"NeeMeanCos {times['nee']:.4f} ms a call")
    return {"lanes": n, "nearest_backward_ms": times["nearest"],
            "plucker_nearest_backward_ms": times["nearest plucker"],
            "nee_backward_ms": times["nee"]}


def nearest_backward_ms(key: str, sweep, o3, scene) -> float:
    """ms of one ``NearestTIdx`` backward (CUDA events, mean of 20 after 3
    warm-ups) on the wavefront of ``o3`` against ``scene``'s own pack, with
    ``o3`` and the three vertex tensors requiring grad: ``sweep(o3, scene)
    -> t`` is the entry that launches the kernel ``key``, once."""
    o3g = o3.detach().clone().requires_grad_(True)
    leaves = {f: getattr(scene, f).detach().clone().requires_grad_(True)
              for f in ("tri_v0", "tri_v1", "tri_v2")}
    reset_launches()
    t = sweep(o3g, dataclasses.replace(scene, **leaves))
    launched = read_launches()[key]
    if launched != 1:
        fail(f"the backward timing of {key}: {launched} launches of {key}, "
             "expected 1")
    gen = torch.Generator(device="cuda").manual_seed(1)
    dt = torch.randn(t.shape[0], generator=gen, device="cuda")
    inputs = [o3g, *leaves.values()]

    def bwd():
        torch.autograd.grad(t, inputs, dt, retain_graph=True)

    for _ in range(3):
        bwd()
    return cuda_ms(bwd, 20)


def grad_train_step(cornell, card: str) -> dict:
    """One training step at the bench configuration (Cornell 512^2, 4 spp,
    4 bounces, 3 NEE, batch_samples) with material, emission and vertex
    params: ms of the forward alone (the loss with its graph), of forward
    and backward, of a whole step (Adam included) and of the no-grad
    render, by CUDA events, median of 10 after 2 warm-ups; peak memory;
    launches of one step; the gradients bit-equal over SCATTER_RUNS runs
    (a gate); one audited backward; and the stream syncs of one backward
    with the kernel and with the weighted bincount it replaced."""
    from pathtracerpython_tpu_torch.diff import (
        adam,
        camera_pixel_loss,
        make_render_fn,
        make_train_step,
    )
    from pathtracerpython_tpu_torch.diff.inverse import apply_params
    from pathtracerpython_tpu_torch.ops import rng
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render

    cfg = RenderConfig(mode="fast", n_samples=CORNELL_SPP,
                       n_bounces=CORNELL_BOUNCES,
                       n_light_samples=NEE_SAMPLES, batch_samples=True)
    with torch.no_grad():
        target = render(cornell, cfg, seed=0)
    params = {f: getattr(cornell, f).detach().clone().requires_grad_(True)
              for f in STEP_FIELDS}
    with torch.no_grad():
        params["mat_rgb"].mul_(0.5)
    pids = torch.arange(target.shape[0], device="cuda")
    render_fn = make_render_fn(cfg)
    keys = iter(rng.split(0, 64))

    def fwd():
        return camera_pixel_loss(params, cornell, target, render_fn, pids,
                                 next(keys))

    def fwd_bwd():
        for p in params.values():
            p.grad = None
        fwd().backward()

    def no_grad_render():
        with torch.no_grad():
            sc = apply_params(cornell, params)
            render(sc, cfg, seed=next(keys))

    opt = adam(0.01)(list(params.values()))
    step = make_train_step(opt, cornell, cfg, target)
    times = {name: statistics.median(timed_runs(fn, warmup=2, reps=10))
             for name, fn in (("render_no_grad", no_grad_render),
                              ("forward", fwd), ("forward_backward", fwd_bwd),
                              ("step", lambda: step(params, next(keys))))}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step(params, rng.split(1)[1])
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    # SCATTER_RUNS runs of one step's gradients from the same params and
    # key: every table gradient is summed by the kernel, so the same bits
    grads = bench_step_grads(cornell)
    runs = [grads((0, 5)) for _ in range(SCATTER_RUNS)]
    hold_bits_equal("training step", runs)
    determinism_audit("train step cornell", lambda: grads((0, 5)))

    def loss():
        return camera_pixel_loss(params, cornell, target, render_fn, pids,
                                 (0, 6))

    syncs = {"scatter_rows kernel": backward_syncs(loss)}
    with bincount_backwards():
        syncs["weighted bincount (before)"] = backward_syncs(loss)
    log(f"[3g] stream syncs in one backward of the training step ({card}; "
        f"sync debug mode 'warn'): {syncs}")
    trace = profile_backward(loss, card)
    if trace["sort_ms_calls"][1]:
        fail(f"training step: one backward ran aten::sort "
             f"{trace['sort_ms_calls'][1]} times; every table of the step "
             "is narrow, so scatter_rows sorts nothing")
    backward = times["forward_backward"] - times["forward"]
    row = {
        "cell": (f"train step cornell {CORNELL_SIZE}^2 {CORNELL_SPP}spp "
                 f"{CORNELL_BOUNCES}b {NEE_SAMPLES}nee"),
        "card": card, "params": list(STEP_FIELDS),
        **{f"{k}_ms": v for k, v in times.items()},
        "backward_ms": backward, "fwd_bwd_ratio": times["forward"] / backward,
        "peak_memory_bytes": peak, "launches_per_step": launches,
        f"grads_bit_equal_across_{SCATTER_RUNS}_runs": True,
        "backward_syncs": syncs, "backward_trace": trace,
    }
    log(f"[3g] training step ({card}): forward {times['forward']:.3f} ms, "
        f"forward+backward {times['forward_backward']:.3f} ms (backward "
        f"{backward:.3f} ms, fwd:bwd {row['fwd_bwd_ratio']:.3f}), whole step "
        f"{times['step']:.3f} ms, the no-grad render {times['render_no_grad']:.3f} "
        f"ms; peak memory {peak / 2**30:.3f} GiB; launches {launches}; "
        f"gradients bit-equal across {SCATTER_RUNS} runs")
    if launches["K1"] != CORNELL_BOUNCES or launches["K2"] != CORNELL_BOUNCES \
            or launches["RNG"] != rng_launches(cfg) \
            or launches["scatter_rows"] < 1:
        fail(f"training step: launches {launches}")
    return row


def profile_backward(loss_fn, card: str, top: int = 6) -> dict:
    """One backward of ``loss_fn()`` under torch.profiler: its device busy
    ms, its device kernels, and the ``top`` operators by self device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    loss = loss_fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss.backward()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    if not kernels:
        fail("profile of the backward: the trace shows no device kernel")
    aten = [e for e in events if e.device_type == DeviceType.CPU
            and e.key.startswith("aten::")]
    ops = sorted(aten, key=lambda e: -e.self_device_time_total)[:top]
    sort = [e for e in aten if e.key == "aten::sort"]
    row = {"device_busy_ms": sum(e.self_device_time_total
                                 for e in kernels) / 1e3,
           "device_kernels": sum(e.count for e in kernels),
           "top_ops_ms": {e.key: [e.self_device_time_total / 1e3, e.count]
                          for e in ops},
           "sort_ms_calls": [sum(e.self_device_time_total for e in sort) / 1e3,
                             sum(e.count for e in sort)]}
    log(f"[3g] one backward under torch.profiler ({card}): device busy "
        f"{row['device_busy_ms']:.3f} ms in {row['device_kernels']} device "
        f"kernels; top operators [ms, calls] {json.dumps(row['top_ops_ms'])}"
        f"; aten::sort [ms, calls] {row['sort_ms_calls']}")
    return row


def grad_hierarchies() -> dict:
    """tri_v0's gradient through the hierarchies on the 100k field at
    HIER_SIZE^2 (1 spp, 2 bounces): accel="auto" (K5, K9 detached),
    "walker" (K8, K9) and "sparse" under mt_impl="plucker" (K3's sparse
    nearest, its any-hit detached) against accel="none" (K1 and K2; K3's
    dense nearest and K2 for the Plücker form), each with its launches and
    run twice for the same bits, each hierarchy's backward audited once;
    and the backward of each hierarchy's nearest sweep timed alone on the
    field's primary rays and pack."""
    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
    from pathtracerpython_tpu_torch.ops.geometry import (
        nearest_hit_cm,
        normalize3,
    )
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import box_field_scene

    scene = pack_scene(box_field_scene(n_boxes=LARGE_BOXES, width=HIER_SIZE,
                                       height=HIER_SIZE), tri_order="morton")
    base = RenderConfig(mode="fast", n_samples=1, n_bounces=2,
                        n_light_samples=NEE_SAMPLES)
    with torch.no_grad():
        target = 0.5 * render(scene, base, seed=1)
    params = {"tri_v0": scene.tri_v0}
    out = {}

    def run(label, **kw):
        cfg = dataclasses.replace(base, **kw)
        reset_launches()
        loss, grads = camera_grads(scene, cfg, params, target, (0, 2))
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_launches().items() if v}
        log(f"[3g] 100k field {HIER_SIZE}^2 {label}: loss {loss!r}, "
            f"|d tri_v0| {grads['tri_v0'].norm().item():.6g}, launches "
            f"{launches}")
        if launches.get("RNG", 0) != rng_launches(cfg):
            fail(f"100k field {label}: {launches.get('RNG', 0)} RNG "
                 f"launches, expected {rng_launches(cfg)}")
        again = camera_grads(scene, cfg, params, target, (0, 2))[1]
        hold_bits_equal(f"100k field {HIER_SIZE}^2 {label}", [grads, again])
        if kw.get("accel", "auto") != "none":
            determinism_audit(f"100k field tri_v0 {label}",
                              lambda: camera_grads(scene, cfg, params,
                                                   target, (0, 2)))
        return grads, launches

    dense, out["none"] = run("accel='none'", accel="none")
    dense_p, out["none plucker"] = run("accel='none' mt_impl='plucker'",
                                       accel="none", mt_impl="plucker")
    o, d = make_primary_rays(scene.eye, scene.ortho, HIER_SIZE, HIER_SIZE)
    o3, d3u = o.T.contiguous(), normalize3(d.T).contiguous()
    errs, backward_ms = {}, {}
    for label, kw, want, ref in (
            ("accel='auto'", {}, ("K5", "K9"), dense),
            ("accel='walker'", dict(accel="walker"), ("K8", "K9"), dense),
            ("accel='sparse' mt_impl='plucker'",
             dict(accel="sparse", mt_impl="plucker"),
             ("K3 sparse nearest", "K3 sparse any-hit"), dense_p)):
        grads, out[label] = run(label, **kw)
        if any(out[label].get(k, 0) < 1 for k in want):
            fail(f"100k field {label}: {want} not launched: {out[label]}")
        errs[label] = hold_grads(f"100k field {label} against accel='none'",
                                 grads, ref, GRAD_RTOL)["tri_v0"]
        backward_ms[want[0]] = nearest_backward_ms(
            want[0], lambda o, sc, kw=kw: nearest_hit_cm(
                o, d3u, sc, **{"accel": "auto", **kw}).t, o3, scene)
    log(f"[3g] NearestTIdx backward alone on the 100k field's "
        f"{o3.shape[1]} primary rays, ms a call: " + json.dumps(backward_ms))
    return {"launches": out, "rel_l2": errs, "backward_ms": backward_ms}


def phase3_grad(cornell, card: str) -> dict:
    """The gradient path: the slice, card against CPU, the Functions'
    forward bits and the backwards' times, the training step at the bench
    configuration and the hierarchies' gradients. A failure fails the
    run."""
    report = {"fit_albedo": grad_fit_slice(card),
              "card_vs_cpu": grad_card_vs_cpu(),
              "forward_bits": grad_forward_bits(cornell, card),
              "train_step": grad_train_step(cornell, card),
              "hierarchies": grad_hierarchies()}
    log("[3g] gradients " + json.dumps(report))
    return report


# The soft-and-pose phase: the soft estimator (diff/boundary.py, plain
# PyTorch: the JAX package's soft sweeps are plain XLA and reach no
# pl.pallas_call), remat_bounces, and the pose and camera apps. Every check
# fails the run.
SOFT_BETA = 0.03        # fit_pose's final beta
SOFT_SIZE = 128         # the stand-in, as the apps load it
SOFT_CHECK_SIZE = 64    # card against CPU
SOFT_CHECK_BETA = 0.05  # the JAX package's tests/test_boundary.py beta
SOFT_FIELD_BOXES = 600  # 7,296 triangles: past SOFT_ACCEL_MIN_TRIS
SOFT_VIS_ATOL = 5e-3    # cluster against dense visibility (dropped terms)
REMAT_RTOL = 1e-6       # remat against no remat, relative L2 per field
LIGHT_STEPS = 30
CAMERA_STEPS = 20
SPP_SWEEP = (1, 2, 4, 8)
# fit_pose --object cube, run once a seed: on the card a run ends either
# near the pose (offset <= 0.048 and yaw <= 0.064 rad) or in a second basin
# (yaw 0.20-0.37), or with the yaw right and the offset off, in about one
# run in three (scripts/soft_fit_seeds.py, measured while the card's float
# atomics made one seed's runs differ; the JAX app stalls on the CPU too;
# since the scatter_rows kernel a seed's runs repeat). A run recovers
# below these bounds, and one run of the three must
FIT_SEEDS = (0, 1, 2)
FIT_RECOVERED_OFFSET = 0.1  # of 0.5
FIT_RECOVERED_YAW = 0.1     # rad, of 0.25
# the rise of a stalled run's 128^2 level, in its last beta stage's loss,
# that the check lets pass: the readings of five whole runs on the H100
# (PERF.md §6) rose once, by 1.34% (seed 5, stalled in the second basin),
# and fell in the 59 other level readings
FIT_STALL_RISE = 0.05
RECOVER_STEPS = 60          # tests/test_torch_pose.py's offset recovery
RECOVER_TOL = 1e-2
# floor patches of the 600-box field whose shadow rays make one cluster
# block each (tests/test_torch_boundary_sparse.py), beside the light: a
# patch under it (x = 0) sends rays in every direction, and its block takes
# up to 226 of the 240 clusters
PATCHES = tuple((x, z) for x in (-4.0, -2.0, 2.0, 4.0) for z in
                (-3.0, -5.0, -9.0, -11.0))


def soft_routing(cornell_soft) -> dict:
    """A soft render of the stand-in at 128^2 (1 spp, 1 bounce, beta
    0.03) launches none of K1-K9."""
    from pathtracerpython_tpu_torch.render.config import RenderConfig

    cfg = RenderConfig(n_samples=1, n_bounces=1, soft_vis_beta=SOFT_BETA)
    rad, launches = render_counted(
        f"soft render stand-in {SOFT_SIZE}^2", cornell_soft, cfg,
        {k: 0 for k in read_launches()})
    check_radiance(f"soft render stand-in {SOFT_SIZE}^2", rad,
                   SOFT_SIZE * SOFT_SIZE)
    return launches


def front_ties(scene, o, d, beta: float) -> torch.Tensor:
    """bool[N]: the rays whose soft front record ties between two
    triangles, their biased keys within 1e-6 relative: a ray that misses a
    quad near its edge has the same t on both of its triangles, so F (and
    the margin that sets the coverage) is picked by the last bit of t, and
    the card and the CPU round it apart."""
    from pathtracerpython_tpu_torch.diff import boundary as bd

    d = bd.safe_normalize(d)
    ok, t, m = bd.plane_hit_and_margin(o[:, None], d[:, None],
                                       scene.tri_v0[None], scene.tri_v1[None],
                                       scene.tri_v2[None])
    keys = torch.where(ok & scene.tri_valid[None] & (t > bd.T_MIN)
                       & (m > -bd.BAND_SIGMAS * beta), bd._f_key(t, m),
                       float("inf"))
    k = torch.topk(keys, 2, dim=1, largest=False).values
    return (k[:, 1] - k[:, 0] <= 1e-6 * k[:, 0].abs()) & torch.isfinite(
        k[:, 0])


def move_object(scene, obj: int, pose):
    """``scene`` with object ``obj`` (material row) moved by ``pose``:
    (dx, dz) or (dx, dz, yaw)."""
    from pathtracerpython_tpu_torch.diff.transforms import transform_object

    zero = torch.zeros((), device=scene.device)
    yaw = pose[2] if len(pose) == 3 else zero
    return transform_object(scene, obj, torch.stack([pose[0], zero,
                                                     pose[1]]), yaw)


def pose_grad(scene, cfg, obj: int, target, pose, keep):
    """d loss / d pose, (dx, dz) or (dx, dz, yaw), of object ``obj`` at
    ``pose``: 0.5 * mean squared error of the camera view against
    ``target`` over the pixels ``keep``, key (0, 3)."""
    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
    from pathtracerpython_tpu_torch.render.integrator import render_rays

    p = torch.tensor(pose, device=scene.device, requires_grad=True)
    w, h = scene.meta.width, scene.meta.height
    o, d = make_primary_rays(scene.eye, scene.ortho, w, h)
    rad = render_rays(o, d, torch.arange(w * h, device=scene.device),
                      move_object(scene, obj, p), cfg, (0, 3))
    err = ((rad - target) ** 2).mean(dim=1)
    (0.5 * (err * keep.to(err.device)).sum() / keep.sum()).backward()
    return p.grad


def ties_per_bounce(scene, cfg, obj: int, pose) -> torch.Tensor:
    """bool[bounces, N] on the CPU: the lanes whose soft front record ties
    (``front_ties``) at each bounce of the render that ``pose_grad`` makes,
    read from the rays each bounce's sweep is given. One lane a pixel: 1
    spp, and no sorting on a scene this small."""
    from pathtracerpython_tpu_torch.diff import boundary
    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
    from pathtracerpython_tpu_torch.render.integrator import render_rays

    sweep, ties = boundary.soft_hits_sweep, []

    def spy(o, d, sc, beta):
        ties.append(front_ties(sc, o, d, beta).cpu())
        return sweep(o, d, sc, beta)

    w, h = scene.meta.width, scene.meta.height
    o, d = make_primary_rays(scene.eye, scene.ortho, w, h)
    boundary.soft_hits_sweep = spy
    try:
        with torch.no_grad():
            render_rays(o, d, torch.arange(w * h, device=scene.device),
                        move_object(scene, obj, torch.tensor(
                            pose, device=scene.device)), cfg, (0, 3))
    finally:
        boundary.soft_hits_sweep = sweep
    return torch.stack(ties)


def hold_pose_grad(label, card, cpu, cfg, obj, target, pose, keep) -> float:
    """``pose_grad`` on the card against the CPU within GRAD_RTOL
    (relative L2) over the pixels ``keep``."""
    g = pose_grad(card, cfg, obj, target.cuda(), pose, keep)
    w = pose_grad(cpu, cfg, obj, target, pose, keep)
    err = rel_l2(g, w)
    log(f"[3s] soft {label}: pose gradient card {g.tolist()} CPU "
        f"{w.tolist()}, relative L2 {err:.3g} over {int(keep.sum())} of "
        f"{keep.numel()} pixels")
    if not torch.isfinite(g).all() or err > GRAD_RTOL:
        fail(f"soft {label}: pose gradient differs by {err}, bound "
             f"{GRAD_RTOL}")
    return err


def soft_card_vs_cpu() -> dict:
    """The occluder scene of tests/test_boundary.py and the stand-in at
    64^2 (1 spp, 2 bounces, 2 NEE, beta 0.05): radiance on the card
    against the CPU. Pose gradients, card against CPU: the blocker's
    translation at 2 bounces over every pixel; the tall cube's planar pose
    (a yaw of 0.02) at 1 bounce over the pixels whose camera ray's front
    record does not tie, and at 2 bounces over the pixels whose front
    record ties at no bounce, on either device (``ties_per_bounce``)."""
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import (
        cornell_box_scene,
        occluder_scene,
    )

    cfg = RenderConfig(n_samples=1, n_bounces=2, n_light_samples=2,
                       soft_vis_beta=SOFT_CHECK_BETA)
    one = dataclasses.replace(cfg, n_bounces=1)
    scenes = {}
    out = {}
    for label, desc in (
            ("occluder", occluder_scene(SOFT_CHECK_SIZE, SOFT_CHECK_SIZE)),
            ("stand-in", cornell_box_scene(SOFT_CHECK_SIZE,
                                           SOFT_CHECK_SIZE))):
        cpu = pack_scene(desc, device="cpu")
        card = cpu.to("cuda")
        want = render(cpu, cfg, seed=3)
        got = render(card, cfg, seed=3)
        hold_close(f"soft {label} {SOFT_CHECK_SIZE}^2 card against CPU",
                   got.cpu(), want)
        scenes[label] = (cpu, card, 0.5 * want)
        out[label] = {"radiance_max_abs_diff":
                      (got.cpu() - want).abs().max().item()}
    every = torch.ones(SOFT_CHECK_SIZE * SOFT_CHECK_SIZE)
    cpu, card, target = scenes["occluder"]
    out["occluder"]["translation_grad_rel_l2_2_bounces"] = hold_pose_grad(
        "occluder translation, 2 bounces", card, cpu, cfg, 1, target,
        (0.05, -0.03), every)
    cpu, card, target = scenes["stand-in"]
    pose = (0.05, -0.03, 0.02)
    ties = ties_per_bounce(cpu, cfg, 5, pose) | ties_per_bounce(card, cfg,
                                                                5, pose)
    log(f"[3s] soft stand-in: lanes whose front record ties, per bounce "
        f"(card or CPU): {ties.sum(dim=1).tolist()}")
    out["stand-in"]["tied_lanes_per_bounce"] = ties.sum(dim=1).tolist()
    out["stand-in"]["pose_grad_rel_l2_1_bounce"] = hold_pose_grad(
        "stand-in planar pose, 1 bounce, untied", card, cpu, one, 5, target,
        pose, (~ties[0]).float())
    out["stand-in"]["pose_grad_rel_l2_2_bounces"] = hold_pose_grad(
        "stand-in planar pose, 2 bounces, untied at every bounce", card, cpu,
        cfg, 5, target, pose, (~ties.any(0)).float())
    # not a check: the tied pixels' share of the 2-bounce gap
    g = pose_grad(card, cfg, 5, target.cuda(), pose, every)
    w = pose_grad(cpu, cfg, 5, target, pose, every)
    out["stand-in"]["pose_grad_rel_l2_2_bounces_every_pixel"] = rel_l2(g, w)
    log(f"[3s] soft stand-in planar pose, 2 bounces, every pixel (tied "
        f"front records flip between the devices; not a check): relative "
        f"L2 {rel_l2(g, w):.3g}")
    return out


def patch_shadow_rays(scene, seed: int = 0):
    """(o, d, maxd) of 256 seeded shadow rays from each floor patch of
    PATCHES to seeded points of the light quad, on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pts = []
    for x, z in PATCHES:
        u = torch.rand((256, 2), generator=gen, device="cuda")
        pts.append(torch.stack([x - 0.3 + 0.6 * u[:, 0],
                                torch.full((256,), -0.99, device="cuda"),
                                z - 0.3 + 0.6 * u[:, 1]], dim=1))
    pts = torch.cat(pts)
    lv = [getattr(scene, f)[0] for f in ("light_v0", "light_v1",
                                         "light_v2")]
    u = torch.rand((pts.shape[0], 2), generator=gen, device="cuda")
    light = lv[0] + u[:, :1] * (lv[1] - lv[0]) + u[:, 1:] * (lv[2] - lv[1])
    vec = light - pts
    return pts, vec, vec.norm(dim=1)


def soft_cluster_sweeps(card: str) -> dict:
    """The 600-box field (morton) at 128^2, beta 0.03: the cluster sweep's
    records against the dense sweep's on the camera rays and on patch
    shadow rays (equal on every lane), its visibility against the dense
    one within SOFT_VIS_ATOL; then one soft render and its backward
    (tri_v0): ms, peak memory and the dense fallbacks."""
    from pathtracerpython_tpu_torch.diff import boundary
    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import box_field_scene

    scene = pack_scene(box_field_scene(n_boxes=SOFT_FIELD_BOXES,
                                       width=SOFT_SIZE, height=SOFT_SIZE),
                       tri_order="morton")
    o, d = make_primary_rays(scene.eye, scene.ortho, SOFT_SIZE, SOFT_SIZE)
    so, sd, smax = patch_shadow_rays(scene)
    out = {"triangles": scene.meta.n_triangles}
    for label, (ro, rd) in (("camera", (o, d)), ("patch shadow", (so, sd))):
        before = boundary.FALLBACKS
        sparse = boundary.soft_hits_sweep_sparse(ro, rd, scene, SOFT_BETA)
        fell = boundary.FALLBACKS - before
        dense = boundary.soft_hits_sweep_dense(ro, rd, scene, SOFT_BETA)
        differ = {f: int((a != b).sum()) for f, a, b in zip(
            sparse._fields, sparse, dense)}
        found = (dense.f_idx != boundary.IMAX).float().mean().item()
        sp_ms = cuda_ms(lambda: boundary.soft_hits_sweep_sparse(
            ro, rd, scene, SOFT_BETA), 3)
        de_ms = cuda_ms(lambda: boundary.soft_hits_sweep_dense(
            ro, rd, scene, SOFT_BETA), 3)
        log(f"[3s] soft records, 600-box field, {ro.shape[0]} {label} rays "
            f"({card}): cluster sweep {sp_ms:.3f} ms ({fell} dense "
            f"fallbacks), dense {de_ms:.3f} ms; lanes that differ {differ}; "
            f"share with a front record {found:.3f}")
        if fell or any(differ.values()):
            fail(f"soft cluster records ({label}): {fell} fallbacks, lanes "
                 f"that differ {differ}")
        out[label] = {"rays": ro.shape[0], "cluster_ms": sp_ms,
                      "dense_ms": de_ms}
    before = boundary.FALLBACKS
    vis = boundary.soft_visibility_sparse(so, sd, smax, scene, SOFT_BETA)
    fell = boundary.FALLBACKS - before
    cov = boundary._soft_visibility_cov(so, sd, smax, scene, SOFT_BETA)
    diff = (vis - (1.0 - torch.clamp_max(cov, 1.0))).abs().max().item()
    log(f"[3s] soft visibility, {so.shape[0]} patch shadow rays: cluster "
        f"against dense max abs diff {diff:.3g} (bound {SOFT_VIS_ATOL}), "
        f"{fell} fallbacks, share of rays under half visible "
        f"{(vis < 0.5).float().mean().item():.3f}")
    if fell or diff > SOFT_VIS_ATOL:
        fail(f"soft visibility: {fell} fallbacks, max abs diff {diff}")
    out["visibility_max_abs_diff"] = diff

    cfg = RenderConfig(n_samples=1, n_bounces=1, soft_vis_beta=SOFT_BETA)
    v0 = scene.tri_v0.clone().requires_grad_(True)
    sc = dataclasses.replace(scene, tri_v0=v0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = boundary.FALLBACKS
    t0 = time.perf_counter()
    rad = render(sc, cfg, seed=0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    rad.mean().backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    fell = boundary.FALLBACKS - before
    with torch.no_grad():
        nograd_ms = cuda_ms(lambda: render(scene, cfg, seed=0), 2)
    check_radiance("soft render 600-box field", rad.detach(),
                   SOFT_SIZE * SOFT_SIZE)
    if not torch.isfinite(v0.grad).all() or v0.grad.abs().sum() == 0:
        fail("soft render 600-box field: tri_v0's gradient is not finite "
             "or zero")
    determinism_audit("soft 600-box field backward", lambda: render(
        dataclasses.replace(scene, tri_v0=scene.tri_v0.clone()
                            .requires_grad_(True)), cfg, seed=0)
        .mean().backward())
    out["render"] = {"forward_ms": (t1 - t0) * 1e3,
                     "backward_ms": (t2 - t1) * 1e3,
                     "no_grad_ms": nograd_ms, "peak_memory_bytes": peak,
                     "dense_fallbacks": fell}
    log(f"[3s] soft render 600-box field {SOFT_SIZE}^2 1 spp 1 b ({card}): "
        f"forward {out['render']['forward_ms']:.1f} ms, backward "
        f"{out['render']['backward_ms']:.1f} ms (host clock, one run), "
        f"no-grad render {nograd_ms:.1f} ms; peak memory "
        f"{peak / 2**30:.3f} GiB; dense fallbacks {fell} (the NEE's shadow "
        "rays span the field in every block)")
    return out


def pose_step_setup(spp: int, beta: float = SOFT_BETA):
    """One step of the object fit on the stand-in at 128^2 (planar pose of
    the tall cube from fit_pose's start, 1 bounce): (loss_fn(params,
    target), the start params requiring grad, the target)."""
    from pathtracerpython_tpu_torch.apps import fit_pose
    from pathtracerpython_tpu_torch.apps.fit_albedo import (
        fit_scene_description,
    )
    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render_rays
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene

    desc, _ = fit_scene_description(None)
    scene = pack_scene(desc)
    _, move, to_pose = fit_pose.pose_model(desc, "cube")
    cfg = RenderConfig(n_samples=spp, n_bounces=1, soft_vis_beta=beta)
    w = scene.meta.width
    rays = (*make_primary_rays(scene.eye, scene.ortho, w, w),
            torch.arange(w * w, device="cuda"))
    with torch.no_grad():
        target = render_rays(*rays, scene, cfg, (0, 0))
    loss_fn = fit_pose.pose_loss(scene, move, to_pose, cfg, rays, (0, 0))
    params = torch.tensor(fit_pose.initial_params("cube", "planar",
                                                  (0.4, 0.0, 0.3), 0.25),
                          device="cuda", requires_grad=True)
    return loss_fn, params, target


def pose_step_times(card: str, spp: int, beta: float = SOFT_BETA) -> dict:
    """``pose_step_setup``'s step: ms of the forward with its graph and of
    forward + backward (CUDA events, median of 5 after 1 warm-up), and the
    peak memory of one step."""
    loss_fn, params, target = pose_step_setup(spp, beta)

    def fwd():
        return loss_fn(params, target)

    def fwd_bwd():
        params.grad = None
        fwd().backward()

    times = {name: statistics.median(timed_runs(fn, warmup=1, reps=5))
             for name, fn in (("forward", fwd), ("forward_backward",
                                                 fwd_bwd))}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd_bwd()
    torch.cuda.synchronize()
    backward = times["forward_backward"] - times["forward"]
    return {"spp": spp, "forward_ms": times["forward"],
            "step_ms": times["forward_backward"], "backward_ms": backward,
            "fwd_bwd_ratio": times["forward"] / backward,
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def level_losses(result: dict, seed: int) -> list[dict]:
    """For each pyramid level of ``fit_pose.run``'s object fit, the loss of
    the level's last beta stage (one objective: that stage's target, the
    run's key) at the pose the level started from and at the one it ended
    with, built here from the run's ``level_params`` as the app builds its
    loss (the stand-in, 1 spp, 1 bounce)."""
    from pathtracerpython_tpu_torch.apps import fit_pose
    from pathtracerpython_tpu_torch.apps.fit_albedo import (
        fit_scene_description,
    )
    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render_rays
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene

    desc, _ = fit_scene_description(None)
    scene = pack_scene(desc)
    _, move, to_pose = fit_pose.pose_model(desc, "cube")
    beta = result["betas"][-1]
    cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=1,
                       soft_vis_beta=beta)
    key = (0, seed)
    out = []
    for level in result["level_params"]:
        lw, lh = level["level"]
        rays = (*make_primary_rays(scene.eye, scene.ortho, lw, lh),
                torch.arange(lw * lh, device="cuda"))
        with torch.no_grad():
            target = render_rays(*rays, scene, cfg, key)
            loss_fn = fit_pose.pose_loss(scene, move, to_pose, cfg, rays, key)
            start, end = (float(loss_fn(torch.tensor(level[k],
                                                     device="cuda"), target))
                          for k in ("start", "end"))
        out.append({"level": [lw, lh], "beta": beta, "start_loss": start,
                    "final_loss": end})
    return out


def one_object_fit(seed: int) -> dict:
    """``apps.fit_pose.run(object_name="cube", seed=seed)`` at the CLI's
    object-mode learning rate (``fit_pose.OBJECT_LR``), the app's other
    defaults: the stand-in at 128^2, planar, 120 steps a level, pyramid
    40^2 then 128^2, 4 beta stages 0.12 -> 0.03, 1 spp, 1 bounce.

    The check compares one objective a level (``level_losses``): the loss
    of the level's last beta stage at the pose the level ended with
    against the pose it started from. A run that recovers the pose must
    lower it at every level. A run that stalls in the second basin must
    lower it at 40^2, and at 128^2, where it starts at that basin's bottom
    (ROADMAP queue C), may raise it by FIT_STALL_RISE at most. The losses
    along the run span four beta stages, each its own objective, so they
    are printed but not compared."""
    import tempfile

    from pathtracerpython_tpu_torch.apps import fit_pose

    with tempfile.TemporaryDirectory() as out:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result = fit_pose.run(object_name="cube", lr=fit_pose.OBJECT_LR,
                              seed=seed, out_dir=out, log=lambda _: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        with open(os.path.join(out, "result.json")) as f:
            losses = json.load(f)["losses"]
    n = len(losses)
    yaw = abs(result["final_angle"][0])
    recovered = (result["final_offset_norm"] < FIT_RECOVERED_OFFSET
                 and yaw < FIT_RECOVERED_YAW)
    log(f"[3s] fit_pose --object cube seed {seed}: {n} steps, losses every "
        f"20th {[round(x, 7) for x in losses[::20]]} last {losses[-1]!r}; "
        f"offset norm {result['init_offset_norm']:.4f} -> "
        f"{result['final_offset_norm']:.4g}, yaw error "
        f"{result['init_angle']:.4f} -> {yaw:.4g} rad "
        f"({'recovered' if recovered else 'not recovered'}); {wall:.2f} s "
        f"wall ({wall / n * 1e3:.1f} ms a step with the target renders), "
        f"peak memory {peak / 2**30:.3f} GiB")
    checks = level_losses(result, seed)
    log(f"[3s] fit_pose --object cube seed {seed}: the last stage's loss at "
        "each level's start and final pose: " +
        ", ".join(f"{c['level'][0]}^2 beta {c['beta']:.3g} "
                  f"{c['start_loss']!r} -> {c['final_loss']!r} (ratio "
                  f"{c['final_loss'] / c['start_loss']!r})" for c in checks))
    # the bound on each level's final loss, as a multiple of its start's
    allowed = [1.0, 1.0] if recovered else [1.0, 1.0 + FIT_STALL_RISE]
    if not (np.isfinite(losses).all() and len(checks) == 2 and all(
            c["final_loss"] < c["start_loss"] * k
            for c, k in zip(checks, allowed))):
        fail(f"fit_pose object seed {seed} "
             f"({'recovered' if recovered else 'stalled'}): a level's "
             f"last-stage loss did not fall from the level's start (a "
             f"stalled run's 128^2 level may rise by {FIT_STALL_RISE}): "
             f"{checks}")
    return {"seed": seed, "losses_every_20th": losses[::20],
            "level_losses": checks,
            "loss_last": losses[-1],
            "final_offset_norm": result["final_offset_norm"],
            "final_yaw_error": yaw, "recovered": recovered, "wall_s": wall,
            "ms_per_step_with_renders": wall / n * 1e3,
            "peak_memory_bytes": peak}


def soft_recover_offset() -> float:
    """tests/test_torch_pose.py's recovery on the card: RECOVER_STEPS Adam
    steps (lr 0.05) of soft-visibility gradients take a 0.3 offset of the
    occluder scene's blocker along x to under RECOVER_TOL."""
    from pathtracerpython_tpu_torch.diff import adam
    from pathtracerpython_tpu_torch.diff.transforms import translate_object
    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render_rays
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import occluder_scene

    scene = pack_scene(occluder_scene())
    cfg = RenderConfig(n_bounces=1, n_light_samples=2, soft_vis_beta=0.05)
    w, h = scene.meta.width, scene.meta.height
    o, d = make_primary_rays(scene.eye, scene.ortho, w, h)
    pids = torch.arange(w * h, device="cuda")
    with torch.no_grad():
        target = render_rays(o, d, pids, scene, cfg, 5)
    dx = torch.tensor(0.3, device="cuda", requires_grad=True)
    zero = torch.zeros((), device="cuda")
    opt = adam(0.05)([dx])
    for _ in range(RECOVER_STEPS):
        opt.zero_grad()
        moved = translate_object(scene, 1, torch.stack([dx, zero, zero]))
        rad = render_rays(o, d, pids, moved, cfg, 5)
        (0.5 * ((rad - target) ** 2).mean()).backward()
        opt.step()
    got = abs(float(dx.detach()))
    log(f"[3s] soft offset recovery, occluder scene: |dx| 0.3 -> {got:.3g} "
        f"in {RECOVER_STEPS} steps (bound {RECOVER_TOL})")
    if not got < RECOVER_TOL:
        fail(f"soft offset recovery: |dx| {got}, bound {RECOVER_TOL}")
    return got


def soft_fit_pose(card: str) -> dict:
    """The object fit on the card: the blocker's offset recovery, then
    ``fit_pose --object cube`` once a seed of FIT_SEEDS, each meeting
    ``one_object_fit``'s level check, and at least one run recovering the
    pose (offset under FIT_RECOVERED_OFFSET and yaw under
    FIT_RECOVERED_YAW); then one step's times at 128^2."""
    recover = soft_recover_offset()
    runs = [one_object_fit(seed) for seed in FIT_SEEDS]
    n_ok = sum(r["recovered"] for r in runs)
    step = pose_step_times(card, 1)
    log(f"[3s] fit_pose --object cube ({card}): recovered in {n_ok} of "
        f"{len(runs)} runs; one step at 128^2, beta 0.03: forward "
        f"{step['forward_ms']:.2f} ms, forward + backward "
        f"{step['step_ms']:.2f} ms, fwd:bwd {step['fwd_bwd_ratio']:.3f}")
    if not n_ok:
        fail(f"fit_pose object: no run of {len(runs)} recovered the pose "
             f"(offset < {FIT_RECOVERED_OFFSET}, yaw < {FIT_RECOVERED_YAW})")
    return {"offset_recovery_abs_dx": recover, "runs": runs,
            "recovered_runs": n_ok, "step_128": step}


def launch_counted_fit(label, run, want: int) -> dict:
    """Run an app's fit with the launch counts set to 0 just before and
    read just after; K1 and K2 must have launched ``want`` times each, the
    RNG twice as often (the backwards launch no sweep and draw nothing)."""
    reset_launches()
    result = run()
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_launches().items() if v}
    log(f"[3s] {label}: launches {launches} (expected K1 = K2 = {want}, "
        f"RNG = {2 * want}; scatter_rows where a table's gradient is summed)")
    if sweep_launches(launches) != {"K1": want, "K2": want} \
            or launches.get("RNG", 0) != 2 * want:
        fail(f"{label}: launches {launches}, expected K1 = K2 = {want}, "
             f"RNG = {2 * want}")
    return {**result, "launches": launches}


def soft_light_and_camera(card: str) -> dict:
    """fit_pose's light mode (LIGHT_STEPS steps) and fit_camera
    (CAMERA_STEPS steps) on the stand-in at 128^2: the lateral and eye
    errors fall; K1 and K2 launch once per sample pass and bounce of every
    step and render, none in the backwards."""
    import tempfile

    from pathtracerpython_tpu_torch.apps import fit_camera, fit_pose

    with tempfile.TemporaryDirectory() as out:
        # the target image, the stage's target, the steps and the fitted
        # image: 1 spp, 1 bounce
        light = launch_counted_fit(
            f"fit_pose light mode {LIGHT_STEPS} steps",
            lambda: fit_pose.run(steps=LIGHT_STEPS, out_dir=out, log=log),
            LIGHT_STEPS + 3)
        # the target and the steps: 2 spp (two passes), 2 bounces
        camera = launch_counted_fit(
            f"fit_camera {CAMERA_STEPS} steps",
            lambda: fit_camera.run(steps=CAMERA_STEPS, out_dir=out, log=log),
            fit_camera.SPP * fit_camera.BOUNCES * (CAMERA_STEPS + 1))
    log(f"[3s] light mode ({card}): lateral offset "
        f"{light['init_offset_norm']:.4f} -> {light['final_offset_norm']:.4g}"
        f"; fit_camera: eye error {camera['eye_err_initial']:.4f} -> "
        f"{camera['eye_err_final']:.4g}")
    if not light["final_offset_norm"] < light["init_offset_norm"]:
        fail(f"fit_pose light: the offset did not fall: {light}")
    if not camera["eye_err_final"] < camera["eye_err_initial"]:
        fail(f"fit_camera: the eye error did not fall: {camera}")
    return {"light": light, "camera": camera}


def remat_step(cornell, card: str) -> dict:
    """The training step of the bench configuration (Cornell 512^2, 4 spp
    as extra lanes, 4 bounces, 3 NEE) with remat_bounces off, then on:
    gradients within REMAT_RTOL per field, K1 and K2 launches a step (4,
    then 8: the recompute launches them again; the RNG's twice as many),
    peak memory and ms a
    step (CUDA events, median of 5 after 1 warm-up)."""
    from pathtracerpython_tpu_torch.diff import (
        adam,
        camera_pixel_loss,
        make_render_fn,
        make_train_step,
    )
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render

    base = RenderConfig(mode="fast", n_samples=CORNELL_SPP,
                        n_bounces=CORNELL_BOUNCES,
                        n_light_samples=NEE_SAMPLES, batch_samples=True)
    with torch.no_grad():
        target = render(cornell, base, seed=0)
    pids = torch.arange(target.shape[0], device="cuda")
    start = {f: getattr(cornell, f).detach().clone() for f in STEP_FIELDS}
    start["mat_rgb"] = start["mat_rgb"] * 0.5
    out, grads = {}, {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat_bounces=remat)
        params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        camera_pixel_loss(params, cornell, target, make_render_fn(cfg), pids,
                          (0, 5)).backward()
        torch.cuda.synchronize()
        launches = {k: v for k, v in read_launches().items() if v}
        peak = torch.cuda.max_memory_allocated()
        grads[remat] = {k: p.grad.clone() for k, p in params.items()}
        step = make_train_step(adam(0.01)(list(params.values())), cornell,
                               cfg, target)
        ms = statistics.median(timed_runs(lambda: step(params, (0, 6)),
                                          warmup=1, reps=5))
        out["remat" if remat else "no_remat"] = {
            "launches": launches, "peak_memory_bytes": peak,
            "ms_per_step": ms}
        want = 2 * CORNELL_BOUNCES if remat else CORNELL_BOUNCES
        log(f"[3s] train step, remat_bounces={remat} ({card}): {ms:.2f} ms "
            f"a step, peak memory {peak / 2**30:.3f} GiB, launches "
            f"{launches}")
        if sweep_launches(launches) != {"K1": want, "K2": want} \
                or launches.get("RNG", 0) != 2 * want:
            fail(f"remat_bounces={remat}: launches {launches}, expected "
                 f"K1 = K2 = {want}, RNG = {2 * want}")
    errs = {k: rel_l2(grads[True][k], grads[False][k]) for k in STEP_FIELDS}
    log("[3s] remat against no remat, relative L2 per field " +
        json.dumps(errs))
    worst = max(errs, key=errs.get)
    if errs[worst] > REMAT_RTOL:
        fail(f"remat_bounces: {worst} differs by {errs[worst]} (relative "
             f"L2), bound {REMAT_RTOL}")
    out["rel_l2"] = errs
    return out


def soft_grads_bit_equal(card: str) -> dict:
    """The soft pose step at 4 spp (``pose_step_setup``) and fit_camera's
    first step (the stand-in at 128^2, 2 spp as passes, 2 bounces, 3 NEE,
    the eye offset by fit_camera.OFFSET, the fit's first key), each run
    twice from the same params and key: the gradients bit-equal; each
    backward audited once."""
    from pathtracerpython_tpu_torch.apps import fit_camera
    from pathtracerpython_tpu_torch.apps.fit_albedo import load_fit_scene
    from pathtracerpython_tpu_torch.ops import rng
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render

    loss_fn, params, target = pose_step_setup(4)

    def pose():
        params.grad = None
        loss_fn(params, target).backward()
        return {"pose": params.grad.clone()}

    hold_bits_equal(f"soft pose step 4 spp ({card})", [pose(), pose()])
    determinism_audit("soft pose step 4 spp", pose)
    scene, _ = load_fit_scene(None, "cuda")
    cfg = RenderConfig(mode="fast", n_samples=fit_camera.SPP,
                       n_bounces=fit_camera.BOUNCES)
    with torch.no_grad():
        target = render(scene, cfg, seed=0)
    start = {"eye": scene.eye + scene.eye.new_tensor(fit_camera.OFFSET)}
    key = rng.split(0)[1]   # the fit's first step

    def camera():
        return camera_grads(scene, cfg, start, target, key)[1]

    hold_bits_equal(f"fit_camera's first step ({card})", [camera(), camera()])
    determinism_audit("fit_camera first step", camera)
    return {"pose_step": "bit-equal", "fit_camera_step": "bit-equal"}


def phase3_soft(cornell, card: str) -> dict:
    """Soft and pose: the routing, the card against the CPU, the cluster
    sweeps, fit_pose in both modes, fit_camera, remat_bounces and the soft
    step against spp. A failure fails the run."""
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import cornell_box_scene

    t0 = time.perf_counter()
    stand_in = pack_scene(cornell_box_scene(SOFT_SIZE, SOFT_SIZE))
    report = {"routing": soft_routing(stand_in),
              "card_vs_cpu": soft_card_vs_cpu(),
              "cluster": soft_cluster_sweeps(card),
              "fit_pose_object": soft_fit_pose(card),
              **soft_light_and_camera(card),
              "bits": soft_grads_bit_equal(card),
              "remat": remat_step(cornell, card)}
    report["spp"] = [pose_step_times(card, spp) for spp in SPP_SWEEP]
    log(f"[3s] soft pose step against spp at {SOFT_SIZE}^2 ({card}; the "
        "sample loop is Python and has no compile cost): " + "; ".join(
            f"{r['spp']} spp {r['step_ms']:.2f} ms a step (forward "
            f"{r['forward_ms']:.2f}), peak "
            f"{r['peak_memory_bytes'] / 2**30:.3f} GiB"
            for r in report["spp"]))
    report["seconds"] = time.perf_counter() - t0
    log("[3s] soft and pose " + json.dumps(report))
    return report


# The reference-and-CLI phase: reference mode (plain PyTorch: the JAX
# package's reference sweeps are XLA's and reach no pl.pallas_call), the CLI
# as a user runs it, progressive checkpointed renders, the native OBJ loader
# and a checkpointed fit. Every check fails the run.
REF_SIZE = 40            # the stand-in at its native size
REF_SPP = 64
REF_BOUNCES = (1, 2)
REF_SEED = 9
CLI_SPP = 4
CLI_BOUNCES = 2
CLI_SEED = 3
CLI_TIMEOUT_S = 600
NATIVE_BOXES = LARGE_BOXES  # 100,000 triangles written out as OBJ
CKPT_FIT_STEPS = 10
CKPT_EVERY = 5


def reference_card_vs_cpu() -> dict:
    """The stand-in at 40x40, 64 spp, 1 and 2 bounces, in reference mode on
    the card and on the CPU: no kernel launched; at 1 bounce the pixels
    that see the light (exactly light_color) and the black ones match
    exactly; radiance within RENDER_RTOL on MIN_PIXELS_CLOSE of pixels."""
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import cornell_box_scene

    desc = cornell_box_scene(REF_SIZE, REF_SIZE)
    card, cpu = pack_scene(desc), pack_scene(desc, device="cpu")
    zero = {k: 0 for k in read_launches()}
    out = {}
    for bounces in REF_BOUNCES:
        label = (f"reference {REF_SIZE}^2 {REF_SPP}spp {bounces}b card "
                 "against CPU")
        cfg = RenderConfig(mode="reference", n_samples=REF_SPP,
                           n_bounces=bounces)
        got, launches = render_counted(label, card, cfg, zero)
        got = got.cpu()
        t0 = time.perf_counter()
        want = render(cpu, cfg, seed=0)
        cpu_s = time.perf_counter() - t0
        if not torch.isfinite(got).all():
            fail(f"{label}: radiance has non-finite values")
        light = cpu.light_color
        masks = {"light": ((got == light).all(dim=1),
                           (want == light).all(dim=1)),
                 "black": ((got == 0).all(dim=1), (want == 0).all(dim=1))}
        if bounces == 1:
            for name, (a, b) in masks.items():
                if not torch.equal(a, b):
                    fail(f"{label}: {name} pixels differ on "
                         f"{int((a != b).sum())} pixels")
        hold_close(label, got, want)
        out[bounces] = {
            "light_pixels": int(masks["light"][0].sum()),
            "black_pixels": int(masks["black"][0].sum()),
            "max_abs_diff": (got - want).abs().max().item(),
            "cpu_render_s": cpu_s}
        log(f"[3r] {label}: {out[bounces]['light_pixels']} light and "
            f"{out[bounces]['black_pixels']} black pixels (equal at 1 "
            f"bounce), CPU render {cpu_s:.2f} s")
    return out


def reference_bench(cornell, card: str) -> dict:
    """Reference mode at the bench configuration (512x512, 4 spp as extra
    lanes, 4 bounces, 3 NEE): ms per render, peak memory, device busy under
    torch.profiler, and the fast render's ms beside it, taken in turns."""
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render

    label = (f"cornell reference {CORNELL_SIZE}^2 {CORNELL_SPP}spp "
             f"{CORNELL_BOUNCES}b")
    cfg = RenderConfig(mode="reference", n_samples=CORNELL_SPP,
                       n_bounces=CORNELL_BOUNCES,
                       n_light_samples=NEE_SAMPLES, batch_samples=True)
    rad, _ = render_counted(label, cornell, cfg,
                            {k: 0 for k in read_launches()})
    if not torch.isfinite(rad).all() or rad.min() == rad.max():
        fail(f"{label}: radiance not finite or constant")
    torch.cuda.reset_peak_memory_stats()
    render(cornell, cfg, seed=1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    row = time_render(label, cornell, CORNELL_SPP, CORNELL_BOUNCES,
                      mode="reference")
    row["peak_memory_bytes"] = peak
    turns = configs_in_turns(
        "[3r]", label.replace(" reference", ""), cornell,
        {mode: dict(mode=mode, n_samples=CORNELL_SPP,
                    n_bounces=CORNELL_BOUNCES)
         for mode in ("fast", "reference")})
    prof = profile_render(label, cornell, CORNELL_SPP, CORNELL_BOUNCES,
                          row["ms_per_render"], mode="reference")
    log(f"[3r] {label} ({card}): {row['ms_per_render']:.3f} ms/render, peak "
        f"{peak / 2**30:.3f} GiB, device busy {prof['device_busy_ms']:.3f} "
        f"ms (idle share {prof['idle_share']:.3f}) in "
        f"{prof['kernel_launches']} device kernels")
    return {"cell": row, "turns": turns, "profile": prof}


def run_processes(jobs: dict) -> dict:
    """Run the commands of ``jobs`` at once from the checkout, the port on
    the path; wait for all, kill any left on a failure. Returns name ->
    (return code, stdout, stderr, seconds)."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p)}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True, cwd=ROOT,
                                 env=env) for k, cmd in jobs.items()}
    out = {}
    try:
        for k, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=CLI_TIMEOUT_S)
            out[k] = (proc.returncode, stdout, stderr,
                      time.perf_counter() - t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for k, (rc, _, stderr, _) in out.items():
        if rc != 0:
            fail(f"CLI {k}: exit status {rc}: {stderr[-2000:]}")
    return out


def cli_phase(card: str) -> dict:
    """The CLI on the card, on the stand-in's SDL written by ``write_sdl``:
    in-process in fast and in reference mode with the launch counts set to
    0 just before and read just after (K1 and K2 once per sample pass and
    bounce in fast mode, no kernel in reference mode); as subprocesses
    (``python -m pathtracerpython_tpu_torch``), whose PNGs must decode to
    ``render_image``'s pixels, whose ``--metrics`` JSON is printed, and
    whose ``--ckpt-dir`` run stopped after chunk 2 of 4 and resumed must
    give the uninterrupted run's accumulation bit for bit."""
    import importlib
    import tempfile

    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.image import read_png
    from pathtracerpython_tpu_torch.render.integrator import render_image
    from pathtracerpython_tpu_torch.scene.arrays import load_scene
    from pathtracerpython_tpu_torch.scene.synthetic import (
        cornell_box_scene,
        write_sdl,
    )
    from pathtracerpython_tpu_torch.utils import CheckpointManager

    cli = importlib.import_module("pathtracerpython_tpu_torch.cli.main")
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        sdl = write_sdl(cornell_box_scene(REF_SIZE, REF_SIZE),
                        os.path.join(tmp, "scene"))
        scene = load_scene(sdl)
        common = [sdl, "-r", str(CLI_SPP), "-b", str(CLI_BOUNCES), "--seed",
                  str(CLI_SEED)]
        # the main path in-process, counted
        want_fast = CLI_SPP * CLI_BOUNCES
        for mode in ("fast", "reference"):
            reset_launches()
            rc = cli.main(common + ["--mode", mode, "--quiet", "--out",
                                    os.path.join(tmp, f"inproc_{mode}.png")])
            torch.cuda.synchronize()
            launches = read_launches()
            want = {k: (want_fast if mode == "fast" and k in ("K1", "K2")
                        else 0) for k in launches}
            want["RNG"] = 2 * want_fast
            log(f"[3r] CLI in-process, {mode} mode: exit {rc}, launches "
                f"{launches}")
            if rc != 0 or launches != want:
                fail(f"CLI {mode}: exit {rc}, launches {launches}, expected "
                     f"{want}")
            report[f"inprocess_{mode}_launches"] = launches
        entry = [sys.executable, "-m", "pathtracerpython_tpu_torch"]
        ckpt = [sdl, "-b", str(CLI_BOUNCES), "--seed", str(CLI_SEED),
                "--chunk-spp", "2"]
        runs = run_processes({
            "fast": entry + common + ["--metrics", "--out",
                                      os.path.join(tmp, "fast.png")],
            "reference": entry + common + ["--mode", "reference", "--out",
                                           os.path.join(tmp, "ref.png")],
            "ckpt_full": entry + ckpt + [
                "-r", "8", "--ckpt-dir", os.path.join(tmp, "full"), "--out",
                os.path.join(tmp, "full.png")],
            "ckpt_part": entry + ckpt + [
                "-r", "4", "--ckpt-dir", os.path.join(tmp, "part"), "--out",
                os.path.join(tmp, "part.png")],
        })
        runs.update(run_processes({"ckpt_resume": entry + ckpt + [
            "-r", "8", "--ckpt-dir", os.path.join(tmp, "part"), "--out",
            os.path.join(tmp, "resumed.png")]}))
        for k, (_, stdout, _, secs) in runs.items():
            log(f"[3r] CLI {k}: {secs:.1f} s; its output:")
            for line in stdout.splitlines():
                log(f"[3r]   {line}")
        for mode, png in (("fast", "fast.png"), ("reference", "ref.png")):
            want = render_image(scene, RenderConfig(
                mode=mode, n_samples=CLI_SPP, n_bounces=CLI_BOUNCES),
                seed=CLI_SEED)
            got = read_png(os.path.join(tmp, png))
            if got.shape != want.shape or not (got == want).all():
                fail(f"CLI {mode}: the PNG is not render_image's pixels "
                     f"({int((got != want).any(axis=-1).sum())} differ)")
        metrics = json.loads([ln for ln in runs["fast"][1].splitlines()
                              if ln.startswith("{")][-1])
        rays = REF_SIZE * REF_SIZE * CLI_SPP * CLI_BOUNCES * (1 + NEE_SAMPLES)
        if metrics["counters"]["rays_attempted"] != rays:
            fail(f"CLI --metrics: {metrics['counters']}, expected {rays} rays")
        if "resumed at chunk 2/4" not in runs["ckpt_resume"][1]:
            fail("CLI --ckpt-dir: the second run did not resume at chunk 2")
        full, part = (CheckpointManager(os.path.join(tmp, d)).restore(4)
                      for d in ("full", "part"))
        if not torch.equal(full["radiance_sum"], part["radiance_sum"]):
            fail("CLI --ckpt-dir: the resumed accumulation differs from the "
                 "uninterrupted one")
        if not (read_png(os.path.join(tmp, "full.png"))
                == read_png(os.path.join(tmp, "resumed.png"))).all():
            fail("CLI --ckpt-dir: the resumed PNG differs")
        log(f"[3r] CLI PNGs equal render_image's pixels (fast, reference); "
            f"resumed accumulation bit-equal to the uninterrupted run; "
            f"metrics {json.dumps(metrics)}")
        report.update(metrics=metrics, seconds={
            k: v[3] for k, v in runs.items()})
    return report


def native_loader_phase() -> dict:
    """The native OBJ loader on a 100,000-triangle box field written out as
    OBJ: whether it was built and used, its parse time and the Python
    parser's, and packed leaves equal between the two."""
    import tempfile

    from pathtracerpython_tpu_torch.scene import native, obj, sdl
    from pathtracerpython_tpu_torch.scene.arrays import DATA_FIELDS, pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import (
        box_field_scene,
        write_sdl,
    )

    used = native.native_available()
    log("[3r] native OBJ loader: " + ("built and used" if used else
                                      "NOT available: the Python parser "
                                      "runs") + f" ({native.library_path()})")
    with tempfile.TemporaryDirectory() as tmp:
        path = write_sdl(box_field_scene(n_boxes=NATIVE_BOXES, width=64,
                                         height=64), tmp)
        t0 = time.perf_counter()
        fast = sdl.load_sdl(path)
        native_s = time.perf_counter() - t0
        loader, sdl.load_obj = sdl.load_obj, obj.load_obj
        try:
            t0 = time.perf_counter()
            slow = sdl.load_sdl(path)
            python_s = time.perf_counter() - t0
        finally:
            sdl.load_obj = loader
    a, b = (pack_scene(d, device="cpu") for d in (fast, slow))
    for f in DATA_FIELDS:
        if not torch.equal(getattr(a, f), getattr(b, f)):
            fail(f"native loader: packed {f} differs from the Python parser's")
    log(f"[3r] {a.meta.n_triangles} triangles: native parse {native_s:.3f} "
        f"s, Python parse {python_s:.3f} s; packed leaves equal")
    return {"native_used": used, "triangles": a.meta.n_triangles,
            "native_parse_s": native_s, "python_parse_s": python_s}


def fit_checkpoint_phase(card: str) -> dict:
    """``fit_albedo --checkpoint-every 5`` for 10 steps on the card, stopped
    at step 5 and resumed, against an uninterrupted run: the resumed run
    starts at step 5, the loss falls, and the two fits' losses and final
    params (their step-10 checkpoints) are equal bit for bit: every step's
    gradients have the same bits on every run."""
    import tempfile

    from pathtracerpython_tpu_torch.apps import fit_albedo
    from pathtracerpython_tpu_torch.utils import CheckpointManager

    def losses(out: str, steps: int) -> list:
        fit_albedo.main(["--steps", str(steps), "--out", out,
                         "--checkpoint-every", str(CKPT_EVERY)])
        with open(os.path.join(out, "result.json")) as f:
            return json.load(f)["losses"]

    with tempfile.TemporaryDirectory() as tmp:
        full = losses(os.path.join(tmp, "full"), CKPT_FIT_STEPS)
        first = losses(os.path.join(tmp, "part"), CKPT_EVERY)
        rest = losses(os.path.join(tmp, "part"), CKPT_FIT_STEPS)
        mgrs = {run: CheckpointManager(os.path.join(tmp, run, "ckpt"))
                for run in ("full", "part")}
        last = mgrs["part"].latest_step()
        params = {run: mgr.restore(CKPT_FIT_STEPS)["params"]
                  for run, mgr in mgrs.items()}
    curve = first + rest
    differ = [k for k in params["full"]
              if not torch.equal(params["part"][k], params["full"][k])]
    log(f"[3r] fit_albedo --checkpoint-every {CKPT_EVERY} on {card}: "
        f"uninterrupted {full}; stopped at {len(first)} and resumed "
        f"{curve}; losses {'equal' if curve == full else 'NOT equal'}, "
        f"final params {sorted(params['full'])} "
        f"{'equal' if not differ else f'NOT equal: {differ}'}")
    if len(first) != CKPT_EVERY or len(rest) != CKPT_FIT_STEPS - CKPT_EVERY \
            or last != CKPT_FIT_STEPS:
        fail(f"fit resume: {len(first)} + {len(rest)} steps, last "
             f"checkpoint {last}")
    if not curve[-1] < curve[0] or curve != full or differ:
        fail(f"fit resume: loss {curve[0]} -> {curve[-1]}; the resumed fit's "
             f"losses or params {differ} differ from the uninterrupted one's")
    return {"uninterrupted": full, "resumed": curve, "bit_equal": True}


def phase3_reference(cornell, card: str) -> dict:
    """Reference mode, the CLI, the native loader and checkpointed fits."""
    t0 = time.perf_counter()
    report = {"card_vs_cpu": reference_card_vs_cpu(),
              "bench": reference_bench(cornell, card),
              "cli": cli_phase(card),
              "native": native_loader_phase(),
              "fit_resume": fit_checkpoint_phase(card)}
    report["seconds"] = time.perf_counter() - t0
    log("[3r] reference and CLI " + json.dumps(report))
    return report


# The parallel phase: parallel/ on torch.distributed. On one card its
# PAR_WORLD ranks share it and talk through gloo with host staging
# (parallel/multihost.py): the milliseconds below are then the machinery's
# cost, not scaling. ``--only 3p --world N`` on a machine with N cards runs
# it with a card and NCCL for each rank. Every check fails the run.
PAR_WORLD = 2
PAR_REPS = 5            # timed renders a turn, after 2 warm-ups
PAR_RING_REPS = 3       # the ring render's timed renders, after 1 warm-up
PAR_TRAIN_SIZE = 128    # the stand-in of the sharded train step
PAR_LOSS_RTOL = 1e-6    # tests/test_diff.py's sharded-step tolerances
PAR_PARAM_RTOL = 1e-5
PAR_PARAM_ATOL = 1e-7
PAR_CLI_SIZE = 64
PAR_RING_GRAD_RTOL = 1e-4   # the hierarchies' tri_v0 gate (shards sum apart)
PAR_SOFT_ATOL = 1e-5        # soft radiance: the coverage sums' order
PAR_SOFT_SPP = 4
PAR_TIMEOUT_S = 900


def par_sync():
    import torch.distributed as dist

    torch.cuda.synchronize()
    dist.barrier()


def probe_gloo_cuda() -> dict:
    """Which gloo collectives take CUDA tensors as they are (the transport
    stages every call anyway): all_reduce, broadcast, all_gather, each
    checked for its result. Send / recv are not tried: a CUDA tensor's
    pointer goes to the socket as if it were host memory, and the failure
    ("writev ... Bad address") tears the pair down. Under NCCL: nothing."""
    import torch.distributed as dist

    if dist.get_backend() != "gloo":
        return {}
    me = dist.get_rank()
    x = torch.full((4,), float(me + 1), device=multihost_device())
    out = {}
    for name in ("all_reduce", "broadcast", "all_gather"):
        try:
            if name == "all_reduce":
                y = x.clone()
                dist.all_reduce(y)
                ok = bool((y == PAR_WORLD * (PAR_WORLD + 1) / 2).all())
            elif name == "broadcast":
                y = x.clone()
                dist.broadcast(y, 0)
                ok = bool((y == 1.0).all())
            else:
                parts = [torch.empty_like(x) for _ in range(PAR_WORLD)]
                dist.all_gather(parts, x)
                ok = bool((torch.cat(parts) == torch.repeat_interleave(
                    torch.arange(1.0, PAR_WORLD + 1, device=x.device),
                    4)).all())
            torch.cuda.synchronize()
            out[name] = "takes CUDA tensors" if ok else "wrong result"
        except RuntimeError as e:
            out[name] = f"refuses: {str(e)[:120]}"
    return out


def multihost_device() -> torch.device:
    from pathtracerpython_tpu_torch.parallel import multihost

    return multihost.device()


def par_timed(fn, warmup: int, reps: int) -> list[float]:
    """CUDA-event milliseconds of each of ``reps`` calls of ``fn`` on every
    rank together (a barrier before each)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        par_sync()
        times.append(cuda_ms(fn, 1))
    return times


def par_dp_bench(say) -> dict:
    """dp = 2 at the bench configuration: the gathered image bit-equal to
    the single-device card render, K1 and K2 4 launches a rank, ms a
    render a rank beside the single-device ms, in turns (single, sharded,
    sharded, single; rank 0 alone renders the single turns)."""
    import torch.distributed as dist

    from pathtracerpython_tpu_torch.parallel import make_mesh, render_sharded
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import cornell_box_scene

    scene = pack_scene(cornell_box_scene(CORNELL_SIZE, CORNELL_SIZE),
                       pad_to=32)
    cfg = RenderConfig(n_samples=CORNELL_SPP, n_bounces=CORNELL_BOUNCES,
                       n_light_samples=NEE_SAMPLES, batch_samples=True)
    mesh = make_mesh(dp=PAR_WORLD)
    with torch.no_grad():
        single = render(scene, cfg, seed=0)
        par_sync()
        reset_launches()
        rad = render_sharded(scene, cfg, mesh, seed=0)
        torch.cuda.synchronize()
        launches = read_launches()
    want = {k: (CORNELL_BOUNCES if k in ("K1", "K2") else 0)
            for k in launches}
    want["RNG"] = rng_launches(cfg)
    if launches != want:
        fail(f"dp bench: launches {launches} a rank, expected {want}")
    diff = float((rad - single).abs().max())
    if not torch.equal(rad, single):
        fail(f"dp bench: the gathered image is not the single-device "
             f"render's (max abs diff {diff})")
    seeds = iter(range(1, 1000))
    times = {"single": [], "sharded": []}
    with torch.no_grad():
        for turn in ("single", "sharded", "sharded", "single"):
            if turn == "single":
                if dist.get_rank() == 0:
                    times[turn] += timed_runs(
                        lambda: render(scene, cfg, seed=next(seeds)), 2,
                        PAR_REPS)
                par_sync()
            else:
                times[turn] += par_timed(
                    lambda: render_sharded(scene, cfg, mesh,
                                           seed=next(seeds)), 2, PAR_REPS)
    row = {"launches_per_rank": launches, "bit_equal": True,
           "max_abs_diff": diff,
           "ms_per_render_sharded": statistics.median(times["sharded"]),
           "ms_sharded_all": times["sharded"]}
    if times["single"]:
        row["ms_per_render_single"] = statistics.median(times["single"])
        row["ms_single_all"] = times["single"]
    say(f"[3p] dp={PAR_WORLD}, cornell {CORNELL_SIZE}^2 {CORNELL_SPP}spp "
        f"{CORNELL_BOUNCES}b: gathered image bit-equal to the single-device "
        f"render; K1 {launches['K1']}, K2 {launches['K2']} launches a rank; "
        f"{row['ms_per_render_sharded']:.3f} ms a render a rank (median of "
        f"{len(times['sharded'])}) against "
        f"{row.get('ms_per_render_single', float('nan')):.3f} single, in "
        f"turns ({'ranks sharing one card: the machinery cost, not scaling' if torch.cuda.device_count() < PAR_WORLD else 'a card a rank'})")
    return row


def par_ring(say) -> dict:
    """geom = 2 on the 100k field: within VARIANT_ATOL of the single-device
    hybrid render, K1 and K4 launched bounces x ring steps a rank, ms a
    render and the bytes the ring moved a render."""
    from pathtracerpython_tpu_torch.parallel import (
        make_mesh,
        render_sharded,
        ring,
    )
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import box_field_scene

    scene = pack_scene(box_field_scene(n_boxes=LARGE_BOXES,
                                       width=CORNELL_SIZE,
                                       height=CORNELL_SIZE),
                       tri_order="morton")
    cfg = RenderConfig(n_samples=LARGE_SPP, n_bounces=LARGE_BOUNCES,
                       n_light_samples=NEE_SAMPLES, batch_samples=True)
    mesh = make_mesh(dp=1, geom=PAR_WORLD)
    with torch.no_grad():
        single = render(scene, cfg, seed=0)
        par_sync()
        reset_launches()
        ring.reset_counts()
        rad = render_sharded(scene, cfg, mesh, seed=0, geom_axis="geom")
        torch.cuda.synchronize()
        launches = read_launches()
        moved, shifts = ring.BYTES_SENT, ring.SHIFTS
    steps = LARGE_BOUNCES * PAR_WORLD
    want = {k: (steps if k in ("K1", "K4") else 0) for k in launches}
    want["RNG"] = rng_launches(cfg)
    if launches != want:
        fail(f"geom ring: launches {launches} a rank, expected {want}")
    diff = float((rad - single).abs().max())
    if not diff <= VARIANT_ATOL:
        fail(f"geom ring: max abs diff {diff} to the single-device hybrid "
             f"render (bound {VARIANT_ATOL})")
    seeds = iter(range(1, 1000))
    with torch.no_grad():
        times = par_timed(lambda: render_sharded(
            scene, cfg, mesh, seed=next(seeds), geom_axis="geom"), 1,
            PAR_RING_REPS)
    row = {"launches_per_rank": launches, "max_abs_diff": diff,
           "padded_triangles": scene.num_padded_triangles,
           "shard_rows": scene.num_padded_triangles // PAR_WORLD,
           "ring_shifts_per_render": shifts,
           "ring_bytes_sent_per_render_per_rank": moved,
           "ms_per_render": statistics.median(times), "ms_all": times}
    say(f"[3p] geom={PAR_WORLD} ring, 100k field {CORNELL_SIZE}^2 "
        f"{LARGE_SPP}spp {LARGE_BOUNCES}b: max abs diff {diff:.3g} to the "
        f"single-device hybrid render; K1 {launches['K1']}, K4 "
        f"{launches['K4']} launches a rank (bounces x steps = {steps}); "
        f"{shifts} shifts and {moved / 2**20:.2f} MiB sent a rank a render; "
        f"{row['ms_per_render']:.3f} ms a render (median of {len(times)})")
    return row


def par_pipeline(say) -> dict:
    """pp = 2 on the Cornell cell's scene at 4 spp, 4 bounces: bit-equal to
    the single-device render with batch_samples=False."""
    from pathtracerpython_tpu_torch.parallel import make_mesh, render_pipelined
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import cornell_box_scene

    scene = pack_scene(cornell_box_scene(CORNELL_SIZE, CORNELL_SIZE),
                       pad_to=32)
    cfg = RenderConfig(n_samples=CORNELL_SPP, n_bounces=CORNELL_BOUNCES,
                       n_light_samples=NEE_SAMPLES)
    mesh = make_mesh(pp=PAR_WORLD, dp=1)
    with torch.no_grad():
        single = render(scene, cfg, seed=0)
        piped = render_pipelined(scene, cfg, mesh, seed=0)
        if not torch.equal(piped, single):
            fail(f"pp pipeline: not bit-equal to the single-device render "
                 f"(max abs diff {float((piped - single).abs().max())})")
        seeds = iter(range(1, 1000))
        times = par_timed(lambda: render_pipelined(scene, cfg, mesh,
                                                   seed=next(seeds)), 1, 3)
    row = {"bit_equal": True, "ms_per_render": statistics.median(times),
           "ms_all": times}
    say(f"[3p] pp={PAR_WORLD} pipeline, cornell {CORNELL_SIZE}^2 "
        f"{CORNELL_SPP}spp {CORNELL_BOUNCES}b: bit-equal to the "
        f"single-device batch_samples=False render; "
        f"{row['ms_per_render']:.3f} ms a render (median of {len(times)})")
    return row


def par_train(say) -> dict:
    """The sharded training step (dp = 2, and geom = 2) on the stand-in at
    PAR_TRAIN_SIZE^2 (the dry run's params, Adam(1e-2)): loss and params
    within tests/test_diff.py's tolerances of the single-device card
    step; each sharded step audited once (a check-only pass)."""
    import torch.distributed as dist

    from pathtracerpython_tpu_torch.diff import adam, make_train_step
    from pathtracerpython_tpu_torch.parallel import make_mesh
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import cornell_box_scene

    scene = pack_scene(cornell_box_scene(PAR_TRAIN_SIZE, PAR_TRAIN_SIZE),
                       pad_to=32)
    cfg = RenderConfig(n_samples=1, n_bounces=2, n_light_samples=NEE_SAMPLES)
    with torch.no_grad():
        target = render(scene, cfg, seed=0)

    def step(mesh, geom_axis):
        params = {"mat_rgb": scene.mat_rgb * 0.5,
                  "light_color": scene.light_color * 1.5,
                  "eye": scene.eye + 0.05}
        params = {k: v.clone().requires_grad_(True)
                  for k, v in params.items()}
        opt = adam(1e-2)(list(params.values()))
        fn = make_train_step(opt, scene, cfg, target, mesh=mesh,
                             geom_axis=geom_axis)
        loss = float(fn(params, (0, 1)))
        return loss, {k: v.detach() for k, v in params.items()}

    loss1, p1 = step(None, None)
    row = {"single_loss": loss1}
    for name, mesh_kw, geom_axis in (
            ("dp", dict(dp=PAR_WORLD), None),
            ("geom", dict(dp=1, geom=PAR_WORLD), "geom")):
        loss, p = step(make_mesh(**mesh_kw), geom_axis)
        determinism_audit(
            f"sharded train step {name}={PAR_WORLD} rank {dist.get_rank()}",
            lambda: step(make_mesh(**mesh_kw), geom_axis))
        rel = abs(loss - loss1) / abs(loss1)
        worst = max(float(((p[k] - p1[k]).abs()
                           - PAR_PARAM_RTOL * p1[k].abs()).max())
                    for k in p)
        row[name] = {"loss": loss, "loss_rel_diff": rel,
                     "param_excess_over_rtol": worst,
                     "param_max_abs_diff": max(
                         float((p[k] - p1[k]).abs().max()) for k in p)}
        say(f"[3p] sharded train step ({name}={PAR_WORLD}): loss {loss!r} "
            f"against {loss1!r} single (rel {rel:.3g}); params max abs diff "
            f"{row[name]['param_max_abs_diff']:.3g}")
        if rel > PAR_LOSS_RTOL or worst > PAR_PARAM_ATOL:
            fail(f"sharded train step ({name}): loss rel diff {rel}, params "
                 f"beyond rtol {PAR_PARAM_RTOL} + atol {PAR_PARAM_ATOL} by "
                 f"{worst}")
    return row


def par_ring_mesh():
    """The ring of the gradient cells: geom = 2, dp over the other ranks
    (dp = 1 x geom = 2 on two ranks, 2 x 2 on four)."""
    from pathtracerpython_tpu_torch.parallel import make_mesh

    return make_mesh(dp=PAR_WORLD // 2, geom=2)


def ray_slice_mask(mesh, lanes: int, index: int, count: int) -> torch.Tensor:
    """bool[lanes]: the rays of ``count`` consecutive ray shards from
    ``index`` of ``render_rays_sharded``'s split over dp x geom."""
    per = lanes // mesh.count(("dp", "geom"))
    mask = torch.zeros(lanes, dtype=torch.bool, device=mesh.device)
    mask[index * per:(index + count) * per] = True
    return mask


def par_ring_train(say) -> dict:
    """The train step cornell cell (512^2, 4 spp as lanes, 4 bounces, 3
    NEE; the stand-in packed to 64 rows) with vertex and light-vertex
    params, under the ring (``par_ring_mesh``), against one device: the
    loss within PAR_LOSS_RTOL, each field's gradient within
    PAR_RING_GRAD_RTOL relative L2; tri_v0's gradient from the rank's own
    rays non-zero on rows of shards it does not own (sent away), and on its
    home rows the gradient of its ring's rays, the other ranks' part
    included (arrived through the reverse shifts); reverse shifts a step
    = bounces x (geom - 1); ms a step in turns with the single step, bytes
    forward and backward, launches and peak memory; the step run again on
    each rank for the same bits, and audited once."""
    import torch.distributed as dist

    from pathtracerpython_tpu_torch.diff import (
        adam,
        apply_params,
        make_render_fn,
        make_train_step,
    )
    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
    from pathtracerpython_tpu_torch.parallel import ring
    from pathtracerpython_tpu_torch.parallel.multihost import transport
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import cornell_box_scene

    scene = pack_scene(cornell_box_scene(CORNELL_SIZE, CORNELL_SIZE),
                       pad_to=32)
    cfg = RenderConfig(n_samples=CORNELL_SPP, n_bounces=CORNELL_BOUNCES,
                       n_light_samples=NEE_SAMPLES, batch_samples=True)
    mesh = par_ring_mesh()
    geom = mesh.shape["geom"]
    rows = scene.num_padded_triangles
    per_rows = rows // geom
    home = slice(mesh.coords["geom"] * per_rows,
                 (mesh.coords["geom"] + 1) * per_rows)
    with torch.no_grad():
        target = render(scene, cfg, seed=0)
    lanes = target.shape[0]
    pids = torch.arange(lanes, device=scene.device)
    key = (0, 7)

    def start():
        params = {f: getattr(scene, f).detach().clone() for f in STEP_FIELDS}
        params["mat_rgb"] *= 0.5
        return {k: v.requires_grad_(True) for k, v in params.items()}

    def grads(render_fn, weight=None):
        """(loss, {field: grad}) of ``camera_pixel_loss``'s 0.5 * mean
        squared error, over the rays ``weight`` [lanes] keeps (all by
        default; the same normalisation)."""
        params = start()
        sc = apply_params(scene, params)
        o, d = make_primary_rays(sc.eye, sc.ortho, CORNELL_SIZE,
                                 CORNELL_SIZE)
        err = ((render_fn(o, d, pids, sc, key) - target) ** 2).mean(dim=1)
        if weight is not None:
            err = err * weight
        loss = 0.5 * err.sum() / lanes
        loss.backward()
        return float(loss.detach()), {k: p.grad.detach().clone()
                                      for k, p in params.items()}

    single_fn, ring_fn = make_render_fn(cfg), make_render_fn(
        cfg, mesh, geom_axis="geom")
    loss1, g1 = grads(single_fn)
    index = mesh.index(("dp", "geom"))
    own = ray_slice_mask(mesh, lanes, index, 1).float()
    mine = ray_slice_mask(mesh, lanes, mesh.coords["dp"] * geom, geom).float()
    _, g_own = grads(single_fn, own)
    _, g_ring_rays = grads(single_fn, mine)
    par_sync()
    ring.reset_counts()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    loss, local = grads(ring_fn)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = read_launches()
    counts = {"shifts": ring.SHIFTS, "bytes_sent": ring.BYTES_SENT,
              "back_shifts": ring.BACK_SHIFTS,
              "back_bytes": ring.BACK_BYTES}
    # the same step again: the same bits on this rank; then one audited
    # backward
    rank = dist.get_rank()
    hold_bits_equal(f"ring train step, rank {rank}",
                    [local, grads(ring_fn)[1]])
    determinism_audit(f"ring train step rank {rank}",
                      lambda: grads(ring_fn))
    group, _ = mesh.line(("dp", "geom"))
    total = {k: transport("all_reduce", v, group) for k, v in local.items()}
    row = {"mesh": dict(mesh.shape), "shard_rows": per_rows, "loss": loss,
           "single_loss": loss1, "grads_bit_equal_across_2_runs": True,
           "loss_rel_diff": abs(loss - loss1) / abs(loss1),
           "grad_rel_l2": {k: rel_l2(total[k], g1[k]) for k in g1},
           "launches_per_rank": launches, **counts,
           "peak_memory_bytes": peak}
    away = torch.ones(rows, dtype=torch.bool, device=scene.device)
    away[home] = False
    sent = float(g_own["tri_v0"][away].norm())
    arrived = float((g_ring_rays["tri_v0"][home] - g_own["tri_v0"][home])
                    .norm())
    row["tri_v0"] = {
        "own_rays_norm_on_rows_not_owned": sent,
        "other_ranks_norm_on_home_rows": arrived,
        "home_rows_rel_l2": rel_l2(local["tri_v0"][home],
                                   g_ring_rays["tri_v0"][home]),
        "home_rows_rel_l2_without_the_others": rel_l2(
            g_own["tri_v0"][home], g_ring_rays["tri_v0"][home])}
    bad = {k: v for k, v in row["grad_rel_l2"].items()
           if not v <= PAR_RING_GRAD_RTOL}
    if row["loss_rel_diff"] > PAR_LOSS_RTOL or bad:
        fail(f"ring train step: loss rel diff {row['loss_rel_diff']}, "
             f"gradients beyond {PAR_RING_GRAD_RTOL} relative L2: {bad}")
    tv = row["tri_v0"]
    if not (sent > 0 and arrived > 0
            and tv["home_rows_rel_l2"] <= PAR_RING_GRAD_RTOL
            and tv["home_rows_rel_l2_without_the_others"]
            > 10 * PAR_RING_GRAD_RTOL):
        fail(f"ring train step: tri_v0's gradient did not travel the ring "
             f"{tv}")
    want_back = CORNELL_BOUNCES * (geom - 1)
    if counts["back_shifts"] != want_back or counts["back_bytes"] == 0:
        fail(f"ring train step: {counts} reverse shifts and bytes, expected "
             f"{want_back} shifts")
    opt1 = start()
    step1 = make_train_step(adam(0.01)(list(opt1.values())), scene, cfg,
                            target)
    optr = start()
    stepr = make_train_step(adam(0.01)(list(optr.values())), scene, cfg,
                            target, mesh=mesh, geom_axis="geom")
    keys = iter(range(100, 1000))
    times = {"single": [], "ring": []}
    for turn in ("single", "ring", "ring", "single"):
        if turn == "single":
            if dist.get_rank() == 0:
                times[turn] += timed_runs(
                    lambda: step1(opt1, (0, next(keys))), 1, PAR_REPS)
            par_sync()
        else:
            times[turn] += par_timed(lambda: stepr(optr, (0, next(keys))),
                                     1, PAR_REPS)
    row["ms_per_step_ring"] = statistics.median(times["ring"])
    row["ms_ring_all"] = times["ring"]
    if times["single"]:
        row["ms_per_step_single"] = statistics.median(times["single"])
        row["ms_single_all"] = times["single"]
    say(f"[3p] ring train step cornell {CORNELL_SIZE}^2 {CORNELL_SPP}spp "
        f"{CORNELL_BOUNCES}b {NEE_SAMPLES}nee, mesh {row['mesh']}, params "
        f"{list(STEP_FIELDS)}: loss rel diff {row['loss_rel_diff']:.3g}; "
        f"gradient rel L2 {row['grad_rel_l2']}; tri_v0 {tv}; {counts} a "
        f"step a rank ({counts['bytes_sent']} B forward, "
        f"{counts['back_bytes']} B backward); launches {launches}; peak "
        f"{peak / 2**30:.3f} GiB; {row['ms_per_step_ring']:.3f} ms a step "
        f"a rank against {row.get('ms_per_step_single', float('nan')):.3f} "
        f"single, in turns")
    return row


def par_soft_pose(say, mesh) -> dict:
    """The soft pose step (the stand-in at 128^2, the tall cube's planar
    pose from fit_pose's start, beta 0.03, 1 bounce, 3 NEE, 4 spp) under
    the ring: radiance within PAR_SOFT_ATOL and the pose gradient within
    PAR_RING_GRAD_RTOL relative L2 of one device; ms a step of each."""
    from pathtracerpython_tpu_torch.apps import fit_pose
    from pathtracerpython_tpu_torch.apps.fit_albedo import (
        fit_scene_description,
    )
    from pathtracerpython_tpu_torch.diff import make_render_fn
    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
    from pathtracerpython_tpu_torch.parallel.multihost import transport
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene

    desc, _ = fit_scene_description(None)
    scene = pack_scene(desc)
    _, move, to_pose = fit_pose.pose_model(desc, "cube")
    cfg = RenderConfig(n_samples=PAR_SOFT_SPP, n_bounces=1,
                       n_light_samples=NEE_SAMPLES, soft_vis_beta=SOFT_BETA)
    w = scene.meta.width
    o, d = make_primary_rays(scene.eye, scene.ortho, w, w)
    pids = torch.arange(w * w, device=scene.device)
    with torch.no_grad():
        target = make_render_fn(cfg)(o, d, pids, scene, (0, 0))
    start = fit_pose.initial_params("cube", "planar", (0.4, 0.0, 0.3), 0.25)
    group, _ = mesh.line(("dp", "geom"))

    def step(render_fn, reduce: bool):
        p = torch.tensor(start, device=scene.device, requires_grad=True)
        off, ang = to_pose(p)
        rad = render_fn(o, d, pids, move(scene, off, ang), (0, 1))
        (0.5 * ((rad - target) ** 2).mean()).backward()
        grad = transport("all_reduce", p.grad, group) if reduce else p.grad
        return rad.detach(), grad

    single_fn = make_render_fn(cfg)
    ring_fn = make_render_fn(cfg, mesh, geom_axis="geom")
    rad1, g1 = step(single_fn, False)
    rad, g = step(ring_fn, True)
    diff = float((rad - rad1).abs().max())
    err = rel_l2(g, g1)
    times = {}
    if mesh.rank == 0:
        times["single"] = statistics.median(timed_runs(
            lambda: step(single_fn, False), 1, 3))
    par_sync()
    times["ring"] = statistics.median(par_timed(lambda: step(ring_fn, True),
                                                1, 3))
    row = {"radiance_max_abs_diff": diff, "pose_grad_rel_l2": err,
           "pose_grad": g.tolist(), "single_pose_grad": g1.tolist(),
           "ms_per_step": times}
    say(f"[3p] soft pose step ring, stand-in {w}^2 {PAR_SOFT_SPP}spp 1b "
        f"beta {SOFT_BETA}: radiance max abs diff {diff:.3g} (bound "
        f"{PAR_SOFT_ATOL}), pose gradient {g.tolist()} against "
        f"{g1.tolist()} single, relative L2 {err:.3g}; ms a step {times}")
    if not diff <= PAR_SOFT_ATOL or not err <= PAR_RING_GRAD_RTOL:
        fail(f"soft pose step ring: radiance diff {diff}, pose gradient "
             f"rel L2 {err}")
    return row


def par_soft_field(say, mesh) -> dict:
    """The soft 600-box field (7,204 triangles, morton; 128^2, 1 spp, 1
    bounce, beta 0.03) under the ring: render and tri_v0 backward against
    one device's DENSE soft sweeps (``boundary.SOFT_ACCEL_MIN_TRIS``
    raised for the oracle: the cluster sweep may leave out shadow terms
    below sigmoid(-6)): radiance within PAR_SOFT_ATOL, the gradient within
    PAR_RING_GRAD_RTOL relative L2; host-clock ms of each, peak memory,
    and the ring's traffic."""
    from pathtracerpython_tpu_torch.diff import boundary, make_render_fn
    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
    from pathtracerpython_tpu_torch.parallel import ring
    from pathtracerpython_tpu_torch.parallel.multihost import transport
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import box_field_scene

    scene = pack_scene(box_field_scene(n_boxes=SOFT_FIELD_BOXES,
                                       width=SOFT_SIZE, height=SOFT_SIZE),
                       tri_order="morton")
    cfg = RenderConfig(n_samples=1, n_bounces=1, soft_vis_beta=SOFT_BETA)
    o, d = make_primary_rays(scene.eye, scene.ortho, SOFT_SIZE, SOFT_SIZE)
    pids = torch.arange(SOFT_SIZE * SOFT_SIZE, device=scene.device)
    group, _ = mesh.line(("dp", "geom"))

    def run(render_fn, reduce: bool):
        v0 = scene.tri_v0.clone().requires_grad_(True)
        sc = dataclasses.replace(scene, tri_v0=v0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rad = render_fn(o, d, pids, sc, (0, 0))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rad.mean().backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        grad = transport("all_reduce", v0.grad, group) if reduce else v0.grad
        return rad.detach(), grad, {
            "forward_ms": (t1 - t0) * 1e3, "backward_ms": (t2 - t1) * 1e3,
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}

    dense_from = boundary.SOFT_ACCEL_MIN_TRIS
    boundary.SOFT_ACCEL_MIN_TRIS = 1 << 30
    try:
        rad1, g1, t_single = run(make_render_fn(cfg), False)
    finally:
        boundary.SOFT_ACCEL_MIN_TRIS = dense_from
    par_sync()
    ring.reset_counts()
    rad, g, t_ring = run(make_render_fn(cfg, mesh, geom_axis="geom"), True)
    counts = {"shifts": ring.SHIFTS, "bytes_sent": ring.BYTES_SENT,
              "back_shifts": ring.BACK_SHIFTS,
              "back_bytes": ring.BACK_BYTES}
    diff = float((rad - rad1).abs().max())
    err = rel_l2(g, g1)
    row = {"triangles": scene.meta.n_triangles,
           "padded_rows": scene.num_padded_triangles,
           "radiance_max_abs_diff": diff, "tri_v0_grad_rel_l2": err,
           "single_dense": t_single, "ring": t_ring, **counts}
    say(f"[3p] soft ring, 600-box field {SOFT_SIZE}^2 1spp 1b: radiance max "
        f"abs diff {diff:.3g} (bound {PAR_SOFT_ATOL}) and tri_v0 gradient "
        f"rel L2 {err:.3g} against one device's dense soft sweeps; ring "
        f"{t_ring}, single dense {t_single} (host clock, one run); {counts} "
        f"a rank")
    if not diff <= PAR_SOFT_ATOL or not err <= PAR_RING_GRAD_RTOL:
        fail(f"soft ring 600-box field: radiance diff {diff}, tri_v0 "
             f"gradient rel L2 {err}")
    if counts["back_shifts"] == 0:
        fail("soft ring 600-box field: no reverse shift")
    return row


def par_soft_ring(say) -> dict:
    mesh = par_ring_mesh()
    return {"pose_step": par_soft_pose(say, mesh),
            "field600": par_soft_field(say, mesh)}


def parallel_rank(rank: int, init: str, out_path: str) -> None:
    """One rank of phase 3p (``chip_smoke.py --parallel-rank``): joins the
    group of PAR_WORLD ranks (gloo on a shared card, NCCL on a card each),
    runs the sharded cases and writes its report as JSON; rank 0 prints."""
    sys.path.insert(0, ROOT)
    from pathtracerpython_tpu_torch.kernels import build
    from pathtracerpython_tpu_torch.parallel import multihost

    say = log if rank == 0 else (lambda *a: None)
    if not os.path.exists(build.library_path()):
        fail("the kernel library was not built before the ranks started")
    multihost.initialize(init_method=init, world_size=PAR_WORLD, rank=rank,
                         log=say)
    try:
        report = {"rank": rank, "backend": multihost.backend(),
                  "transport": multihost.describe_transport(),
                  "device": str(multihost.device()),
                  "gloo_cuda": probe_gloo_cuda()}
        say(f"[3p] backend {report['backend']} on {report['device']}; gloo "
            f"on CUDA tensors: {report['gloo_cuda'] or 'not gloo'}")
        report["dp_bench"] = par_dp_bench(say)
        report["geom_ring"] = par_ring(say)
        report["pipeline"] = par_pipeline(say)
        report["train_step"] = par_train(say)
        report["ring_train"] = par_ring_train(say)
        report["soft_ring"] = par_soft_ring(say)
        report["audit"] = AUDIT
        multihost.sync()
    finally:
        multihost.shutdown()
    with open(out_path, "w") as f:
        json.dump(report, f)


def par_cli(tmp: str) -> dict:
    """The CLI under torchrun with --dp 2 on the shared card: its PNG equal
    to the one-process CLI's."""
    from pathtracerpython_tpu_torch.render.image import read_png
    from pathtracerpython_tpu_torch.scene.synthetic import (
        cornell_box_scene,
        write_sdl,
    )

    sdl = write_sdl(cornell_box_scene(PAR_CLI_SIZE, PAR_CLI_SIZE),
                    os.path.join(tmp, "cli_scene"))
    common = [sdl, "-r", str(CLI_SPP), "-b", str(CLI_BOUNCES), "--seed",
              str(CLI_SEED)]
    runs = run_processes({
        "one process": [sys.executable, "-m", "pathtracerpython_tpu_torch",
                        *common, "--out", os.path.join(tmp, "one.png")],
        "torchrun --dp 2": [
            sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(PAR_WORLD), "-m",
            "pathtracerpython_tpu_torch", *common, "--dp", str(PAR_WORLD),
            "--out", os.path.join(tmp, "two.png")]})
    one = read_png(os.path.join(tmp, "one.png"))
    two = read_png(os.path.join(tmp, "two.png"))
    if not np.array_equal(one, two):
        fail("CLI under torchrun --dp 2: its PNG is not the one-process "
             "CLI's")
    out = runs["torchrun --dp 2"][1]
    log(f"[3p] CLI under torchrun --dp {PAR_WORLD}: PNG equal to the "
        f"one-process CLI's; its log: "
        f"{[ln for ln in out.splitlines() if 'parallel' in ln or 'mesh' in ln]}"
        f"; {runs['torchrun --dp 2'][3]:.1f} s")
    return {"png_equal": True, "seconds": runs["torchrun --dp 2"][3]}


_NCCL_ONE_RANK = """
import sys
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[2])
from pathtracerpython_tpu_torch.parallel.multihost import transport
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method=sys.argv[1], world_size=1,
                        rank=0)
x = torch.arange(8, dtype=torch.float32, device="cuda")
y = transport("all_gather", x)
torch.cuda.synchronize()
assert torch.equal(x, y), (x, y)
print(dist.get_backend(), y.device, y.tolist())
dist.destroy_process_group()
"""


def par_nccl_one_rank(tmp: str) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", _NCCL_ONE_RANK,
         "file://" + os.path.join(tmp, "nccl_rendezvous"), ROOT],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"one-rank NCCL group: {proc.stderr[-2000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    log(f"[3p] one-rank NCCL group, all_gather through the transport: {line}")
    return line


def phase3_parallel(card: str) -> dict:
    """parallel/ on the card: PAR_WORLD ranks on the one card (dp bench,
    geom ring, pp pipeline, sharded train steps), the CLI under torchrun,
    ``entry.dryrun_multichip(2)`` and a one-rank NCCL group."""
    import tempfile

    from pathtracerpython_tpu_torch.entry import dryrun_multichip
    from pathtracerpython_tpu_torch.kernels import build

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    how = (f"share the one card ({card}) through gloo with host staging; "
           "their ms are the machinery's cost on one card, not scaling"
           if cards < PAR_WORLD else
           f"each drive a card of their own ({cards} x {card}) over NCCL")
    log(f"[3p] parallel: {PAR_WORLD} ranks {how}. The kernel library was "
        f"built once before the ranks start: {build.library_path()}")
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(PAR_WORLD)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-rank",
             str(r), "--init", init, "--out", outs[r], "--world",
             str(PAR_WORLD)], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(PAR_WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=PAR_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for line in logs[0].splitlines():
            log(line)
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            fail(f"parallel ranks {bad} failed:\n"
                 + "\n".join(logs[r][-3000:] for r in bad))
        ranks = []
        for path in outs:
            with open(path) as f:
                ranks.append(json.load(f))
        report["ranks"] = ranks
        report["cli"] = par_cli(tmp)
        t1 = time.perf_counter()
        dryrun_multichip(PAR_WORLD, log=lambda s: log(f"[3p] {s}"))
        report["dryrun_seconds"] = time.perf_counter() - t1
        report["nccl_one_rank"] = par_nccl_one_rank(tmp)
    report["seconds"] = time.perf_counter() - t0
    log(f"[3p] parallel phase: {report['seconds']:.1f} s")
    log("[3p] parallel " + json.dumps(report))
    return report


def time_render(label, scene, spp, bounces, reps: int = 10,
                nee: int = NEE_SAMPLES, mode: str = "fast", **cfg_kw) -> dict:
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render

    cfg = RenderConfig(mode=mode, n_samples=spp, n_bounces=bounces,
                       n_light_samples=nee, batch_samples=True, **cfg_kw)
    seeds = iter(range(1000))
    times = timed_runs(lambda: render(scene, cfg, seed=next(seeds)),
                      warmup=2, reps=reps)
    ms = statistics.median(times)
    pixels = scene.meta.width * scene.meta.height
    segments = pixels * spp * bounces
    all_rays = segments * (1 + nee)
    row = {
        "cell": label, "triangles": scene.meta.n_triangles,
        "padded_triangles": scene.num_padded_triangles,
        "ms_per_render": ms, "ms_min": min(times), "ms_max": max(times),
        "timed_renders": reps,
        "mrays_per_s_all": all_rays / (ms * 1e3),
        "mrays_per_s_segments": segments / (ms * 1e3),
    }
    log(f"[4] {label}: {ms:.3f} ms/render (median of {reps}; min {min(times):.3f},"
        f" max {max(times):.3f}); {row['mrays_per_s_all']:.2f} Mrays/s all "
        f"rays, {row['mrays_per_s_segments']:.2f} Mrays/s path segments")
    return row


def time_in_turns(label, scene, spp, bounces, **cfg_kw) -> list[dict]:
    """A cell in its classic and its Plücker form, timed in turns on the
    same card in one run (classic, Plücker, Plücker, classic; 5 renders a
    turn after 2 warm-up renders each, median of each form's 10), which is
    how two versions are compared: a cell timed minutes apart meets another
    host load."""
    return configs_in_turns(
        "[4]", label.removesuffix(" plucker"), scene,
        {form: dict(mode="fast", n_samples=spp, n_bounces=bounces,
                    mt_impl=form, **cfg_kw)
         for form in ("classic", "plucker")})


def configs_in_turns(tag, label, scene, configs: dict) -> list[dict]:
    """Two render configurations ``configs`` (name -> RenderConfig fields,
    NEE_SAMPLES and batch_samples added) timed in turns on one card in one
    run: a, b, b, a, 5 renders a turn after 2 warm-up renders each, median
    of each one's 10."""
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render

    seeds = iter(range(1000))
    runs = {name: (lambda cfg=RenderConfig(
        n_light_samples=NEE_SAMPLES, batch_samples=True, **kw):
        render(scene, cfg, seed=next(seeds))) for name, kw in configs.items()}
    a, b = runs
    times = {a: [], b: []}
    for name in runs:
        timed_runs(runs[name], warmup=2, reps=0)
    for name in (a, b, b, a):
        times[name] += timed_runs(runs[name], warmup=0, reps=5)
    rows = []
    for name, ts in times.items():
        ms = statistics.median(ts)
        rows.append({"cell": f"{label} {name}, in turns", "ms_per_render": ms,
                     "ms_min": min(ts), "ms_max": max(ts),
                     "timed_renders": len(ts)})
        log(f"{tag} {label} {name}, in turns: {ms:.3f} ms/render (median of "
            f"{len(ts)}; min {min(ts):.3f}, max {max(ts):.3f})")
    return rows


def profile_render(label, scene, spp, bounces, render_ms, reps: int = 10,
                   nee: int = NEE_SAMPLES, **cfg_kw) -> dict:
    """One render under torch.profiler: device-busy time split into the
    port's kernels and PyTorch's own, the device's idle share against the
    untraced median ``render_ms``, and the busiest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.render.integrator import render

    cfg = RenderConfig(n_samples=spp, n_bounces=bounces,
                       n_light_samples=nee, batch_samples=True, **cfg_kw)
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
    busy_us = {k: 0.0 for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7",
                                "K8", "K9", "torch")}
    for e in kernels:
        group = ("K3" if "PluckerForm" in e.key else
                 "K5" if "sparse_nearest_kernel" in e.key else
                 "K6" if "sparse_any_hit_kernel" in e.key else
                 "K7" if ("sparse_any_hit_idx_kernel" in e.key
                          or "blocking_cluster_kernel" in e.key) else
                 "K8" if "walker_nearest_kernel" in e.key else
                 "K9" if "walker_any_hit_kernel" in e.key else
                 "K1" if "nearest_kernel" in e.key else
                 "K4" if "any_hit_kernel" in e.key else
                 "K2" if "nee_kernel" in e.key else "torch")
        busy_us[group] += e.self_device_time_total
    busy_ms = sum(busy_us.values()) / 1e3
    row = {
        "cell": label, "traced_wall_ms": traced_ms, "device_busy_ms": busy_ms,
        "idle_share": 1.0 - busy_ms / render_ms,
        "kernel_launches": sum(e.count for e in kernels),
        **{f"{k}_ms": v / 1e3 for k, v in busy_us.items()},
    }
    split = ", ".join(f"{k} {row[f'{k}_ms']:.3f} ms" for k in busy_us
                      if k != "torch" and busy_us[k] > 0)
    log(f"[profile] {label}: device busy {busy_ms:.3f} ms of the untraced "
        f"{render_ms:.3f} ms (idle share {row['idle_share']:.3f}); {split}, "
        f"PyTorch kernels {row['torch_ms']:.3f} ms in "
        f"{row['kernel_launches']} device kernels; traced wall "
        f"{traced_ms:.3f} ms")
    log(prof.key_averages().table(sort_by="self_device_time_total",
                                  row_limit=12, max_name_column_width=60))
    return row


def _arg(flag: str) -> str | None:
    """The value after ``flag`` on the command line, None without it."""
    argv = sys.argv[1:]
    return argv[argv.index(flag) + 1] if flag in argv else None


def main() -> None:
    global PAR_WORLD
    started = time.monotonic()
    PAR_WORLD = int(_arg("--world") or PAR_WORLD)
    rank = _arg("--parallel-rank")
    if rank is not None:
        # one rank of phase 3p, started by phase3_parallel
        parallel_rank(int(rank), _arg("--init"), _arg("--out"))
        return
    card, name = phase0_identity()
    timed("phase 1", phase1_build)
    only = _arg("--only")
    if only is not None:
        # phase 3p alone, for working on it: no result lines
        if only != "3p":
            fail(f"--only {only}: only phase 3p runs alone")
        phase3_parallel(card)
        log("[only] phase 3p passed")
        return

    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import (
        box_field_scene,
        cornell_box_scene,
    )

    # the scene constructors build on the card
    cornell = pack_scene(cornell_box_scene(CORNELL_SIZE, CORNELL_SIZE),
                         pad_to=32)
    field = pack_scene(box_field_scene(n_boxes=FIELD_BOXES,
                                       width=CORNELL_SIZE,
                                       height=CORNELL_SIZE))
    morton = pack_scene(box_field_scene(n_boxes=FIELD_BOXES,
                                        width=CORNELL_SIZE,
                                        height=CORNELL_SIZE),
                        tri_order="morton")
    many = pack_scene(box_field_scene(n_boxes=FIELD_BOXES,
                                      width=MANY_NEE_SIZE,
                                      height=MANY_NEE_SIZE))
    large = pack_scene(box_field_scene(n_boxes=LARGE_BOXES,
                                       width=CORNELL_SIZE,
                                       height=CORNELL_SIZE),
                       tri_order="morton")
    if large.device.type != "cuda":
        fail(f"pack_scene built on {large.device}, not on the card")
    log(f"[2] scenes: Cornell stand-in ({cornell.meta.path}, "
        f"{cornell.meta.n_triangles} tris), box field "
        f"({field.meta.n_triangles} tris, {field.num_padded_triangles} "
        f"padded) and large box field ({large.meta.n_triangles} tris, "
        f"{large.num_padded_triangles} padded, morton order); no scene file "
        "is read")
    rows = timed("phase 2", phase2_kernels,
                 [("cornell", cornell), ("boxfield", field)], morton, many,
                 large)
    rows["scatter_rows"] = timed("phase 2 scatter_rows", phase2_scatter,
                                 cornell, large)
    rng_rows = timed("phase 2 rng", phase2_rng)
    launches = {**timed("phase 3", phase3_render, cornell, large, many),
                **timed("phase 3 probes", phase3_probes)}
    grads = timed("phase 3g", phase3_grad, cornell, card)
    # the table gradients' sum launches in the backwards: its count is one
    # bench training step's
    launches["scatter_rows"] = grads["train_step"]["launches_per_step"][
        "scatter_rows"]
    timed("phase 3s", phase3_soft, cornell, card)
    timed("phase 3r", phase3_reference, cornell, card)
    parallel = timed("phase 3p", phase3_parallel, card)
    large_label = (f"large100k {CORNELL_SIZE}^2 {LARGE_SPP}spp "
                   f"{LARGE_BOUNCES}b")
    cell_args = [
        ((f"cornell {CORNELL_SIZE}^2 {CORNELL_SPP}spp {CORNELL_BOUNCES}b",
          cornell, CORNELL_SPP, CORNELL_BOUNCES), {}),
        ((f"boxfield{FIELD_BOXES} {CORNELL_SIZE}^2 {FIELD_SPP}spp "
          f"{FIELD_BOUNCES}b", field, FIELD_SPP, FIELD_BOUNCES), {}),
        ((large_label + " hybrid", large, LARGE_SPP, LARGE_BOUNCES), {}),
        ((large_label + " sparse", large, LARGE_SPP, LARGE_BOUNCES),
         dict(accel="sparse")),
        ((large_label + " sparse+cache", large, LARGE_SPP, LARGE_BOUNCES),
         dict(accel="sparse", nee_cache="on", reps=5)),
        ((large_label + " walker", large, LARGE_SPP, LARGE_BOUNCES),
         dict(accel="walker", reps=5)),
        ((f"cornell {CORNELL_SIZE}^2 {CORNELL_SPP}spp {CORNELL_BOUNCES}b "
          "plucker", cornell, CORNELL_SPP, CORNELL_BOUNCES),
         dict(mt_impl="plucker")),
        ((large_label + " sparse plucker", large, LARGE_SPP, LARGE_BOUNCES),
         dict(accel="sparse", mt_impl="plucker")),
        ((large_label + " hybrid plucker", large, LARGE_SPP, LARGE_BOUNCES),
         dict(mt_impl="plucker")),
        ((f"boxfield{FIELD_BOXES} {MANY_NEE_SIZE}^2 {MANY_NEE_SPP}spp "
          f"{MANY_NEE_BOUNCES}b {MANY_NEE_SAMPLES}nee", many, MANY_NEE_SPP,
          MANY_NEE_BOUNCES), dict(nee=MANY_NEE_SAMPLES)),
    ]
    cells = timed("phase 4", lambda: [time_render(*args, **kw)
                                      for args, kw in cell_args])
    log("[4] cells " + json.dumps(cells))
    turns = timed("phase 4 turns", lambda: [
        row for (args, kw) in cell_args if kw.get("mt_impl")
        for row in time_in_turns(*args, **{
            k: v for k, v in kw.items() if k != "mt_impl"})])
    log("[4] classic and Plücker in turns " + json.dumps(turns))
    if "--profile" in sys.argv[1:]:
        prof = [profile_render(*args, c["ms_per_render"], **kw)
                for (args, kw), c in zip(cell_args, cells)]
        log("[profile] " + json.dumps(prof))
    log("[2] sweep x hierarchy " + json.dumps(
        {k: [{f: r[f] for f in r if f not in ("err",)} for r in rows[k]]
         for k in ("K5", "K5@512", "K8", "K6", "K7", "K9",
                   "K3 sparse nearest", "K3 sparse any-hit",
                   *TWO_PASS_KEYS)}))
    log("[2] scatter_rows " + json.dumps(rows["scatter_rows"]))
    log("[2] K3 beside its classic twins " + json.dumps(
        {k: [{f: r[f] for f in ("label", "ms", "classic_ms", "classic_agree")}
             for r in rows[k]] for k in ("K3 nearest", "K3 any-hit")}))
    log("[2] culled sweeps " + json.dumps(
        {k: [{f: r[f] for f in r if f != "err"} for r in rows[k]]
         for k in ("K1", "K3 nearest", "K2", "K4", "K3 any-hit", "K1 morton",
                   "K3 nearest morton", "K2 morton", "K4 morton",
                   "K1 large100k")}))

    # the backward of each kernel that has one: its name and its ms a call
    # on the kernel's own wavefront (K1, K3's dense nearest and K2 the
    # Cornell bench's primary rays; K5, K8 and K3's sparse nearest the 100k
    # field's); the any-hits are detached
    bits, hier = grads["forward_bits"], grads["hierarchies"]["backward_ms"]
    BACKWARDS = {"K1": (NEAREST_BACKWARD, bits["nearest_backward_ms"]),
                 "K3 nearest": (NEAREST_BACKWARD,
                                bits["plucker_nearest_backward_ms"]),
                 "K5": (NEAREST_BACKWARD, hier["K5"]),
                 "K8": (NEAREST_BACKWARD, hier["K8"]),
                 "K3 sparse nearest": (NEAREST_BACKWARD,
                                       hier["K3 sparse nearest"]),
                 "K2": (NEE_BACKWARD, bits["nee_backward_ms"]),
                 "K5 two-pass": (NEAREST_BACKWARD, hier["K5"]),
                 "K5@512 two-pass": (NEAREST_BACKWARD, hier["K5"]),
                 "K6 two-pass": (NO_BACKWARD, None),
                 "two-pass select": ("none (its flags choose lanes; no "
                                     "gradient flows through them)", None),
                 "scatter_rows": (SCATTER_BACKWARD, None)}
    # each kernel at its main path's first wavefront: K1, K2 the Cornell
    # primary rays, K4 the first shadow rays of the 300-box field's render
    # with 9 NEE samples (the render its launches are counted on), K3's
    # dense any-hit the 300-box field's first shadow rays, K5 to K9 the
    # 100k field's first bounce (every block, the lists built beforehand
    # for kernel and plain alike; K7 on the full lists); K3's four sweeps
    # beside their classic twins' wavefronts; P1 and P2 on their own tiles
    # each rank's launches in phase 3p: the dp bench render, one ring
    # render (bounces x ring steps) and one ring training step (the same
    # forward launches; the backward re-solves in plain PyTorch); the soft
    # ring launches none
    rank0 = parallel["ranks"][0]
    dp_l, ring_l, train_l = (
        rank0["dp_bench"]["launches_per_rank"],
        rank0["geom_ring"]["launches_per_rank"],
        rank0["ring_train"]["launches_per_rank"])
    par_launches = {"K1": {"dp": dp_l["K1"], "geom ring": ring_l["K1"],
                           "geom ring train step": train_l["K1"]},
                    "K2": {"dp": dp_l["K2"]},
                    "K4": {"geom ring": ring_l["K4"],
                           "geom ring train step": train_l["K4"]}}
    kernels = []
    for key, entry, src, replaces in (
        ("K1", "K1 nearest_t_idx_cm", "nearest.cu",
         "pathtracerpython_tpu/kernels/intersect_pallas.py:489"),
        ("K2", "K2 nee_mean_cos_fused", "nee.cu",
         "pathtracerpython_tpu/kernels/nee_pallas.py:226"),
        ("K4", "K4 any_hit_cm", "any_hit.cu",
         "pathtracerpython_tpu/kernels/intersect_pallas.py:599"),
        ("K5", "K5 sparse_nearest_t_idx_cm", "sparse_nearest.cu",
         "pathtracerpython_tpu/kernels/sparse_pallas.py:1694"),
        ("K6", "K6 sparse_any_hit_cm", "sparse_any_hit.cu",
         "pathtracerpython_tpu/kernels/sparse_pallas.py:1804"),
        ("K7", "K7 sparse_any_hit_cached_cm", "sparse_any_hit_idx.cu",
         "pathtracerpython_tpu/kernels/sparse_pallas.py:1182"),
        ("K8", "K8 walker_nearest_t_idx_cm", "walker_nearest.cu",
         "pathtracerpython_tpu/kernels/walker_pallas.py:340"),
        ("K9", "K9 walker_any_hit_cm", "walker_any_hit.cu",
         "pathtracerpython_tpu/kernels/walker_pallas.py:374"),
        ("K3 nearest", "K3 nearest_t_idx_cm mt_impl=plucker", "nearest.cu",
         "pathtracerpython_tpu/kernels/intersect_pallas.py:489"),
        ("K3 any-hit", "K3 any_hit_cm mt_impl=plucker", "any_hit.cu",
         "pathtracerpython_tpu/kernels/intersect_pallas.py:599"),
        ("K3 sparse nearest", "K3 sparse_nearest_t_idx_cm mt_impl=plucker",
         "sparse_nearest.cu",
         "pathtracerpython_tpu/kernels/sparse_pallas.py:1694"),
        ("K3 sparse any-hit", "K3 sparse_any_hit_cm mt_impl=plucker",
         "sparse_any_hit.cu",
         "pathtracerpython_tpu/kernels/sparse_pallas.py:1804"),
        *((key, f"{key} probes.mma_probe", "probe_plucker.cu",
           "scripts/mxu_probe.py:136") for key in P1_KEYS),
        *((key, f"{key} probes.bf16_probe", "probe_bf16.cu",
           "scripts/bf16_probe.py:82") for key in P2_KEYS),
        ("K5 two-pass", "K5 sparse_nearest_t_idx_cm two_pass=4 "
         "r_blk=1024 (pass 1, select, pass 2, fallback)",
         "sparse_nearest.cu",
         "pathtracerpython_tpu/kernels/sparse_pallas.py:1713"),
        ("K5@512 two-pass", "K5 sparse_nearest_t_idx_cm two_pass=4 "
         "r_blk=512 (pass 1, select, pass 2, fallback)", "sparse_nearest.cu",
         "pathtracerpython_tpu/kernels/sparse_pallas.py:1713"),
        ("K6 two-pass", "K6 sparse_any_hit_cm two_pass=4 (pass 1, select, "
         "pass 2, fallback)", "sparse_any_hit.cu",
         "pathtracerpython_tpu/kernels/sparse_pallas.py:1820"),
        ("two-pass select", "two-pass select select_compact (the occluder "
         "cache) / nearest_select_compact / any_hit_select_compact",
         "two_pass.cu",
         "pathtracerpython_tpu/kernels/sparse_pallas.py:430"),
        ("scatter_rows", "scatter_rows ops/gather.py (every table "
         "gradient)", "scatter_rows.cu",
         "pathtracerpython_tpu/ops/gather.py:50"),
    ):
        main_label = {"K4": f"{MANY_NEE_LABEL} bounce 1",
                      "K3 any-hit": "boxfield bounce 1"}.get(
                          key, rows[key][0]["label"])
        first = next(r for r in rows[key] if r["label"] == main_label)
        backward = BACKWARDS.get(key, (NO_BACKWARD if key.startswith("K")
                                       else "none (a probe: no training "
                                       "path runs it)", None))
        kernels.append({
            "name": entry, "route": "cuda",
            "source": f"pathtracerpython_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": max(r["err"] for r in rows[key]),
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": first.get("library_ms"),
            "backward": backward[0],
            **({"backward_ms": backward[1]} if backward[1] else {}),
            **{k: first[k] for k in CULL_KEYS if k in first},
            **({k: first[k] for k in ANY_HIT_WALK_KEYS}
               if "gate_pairs" in first else {}),
            **({"parallel_launches_per_rank": par_launches[key]}
               if key in par_launches else {}),
            **{k: first[k] for k in PROBE_KEYS if k in first},
            **({k: first[k] for k in TWO_PASS_ROW_KEYS if k in first}
               if key in TWO_PASS_KEYS else {}),
            **({"tpu_kernel": "none: _lane_unseen_bound, the finality "
                              "tests, _compact_select, _gather_parked and "
                              "lax.cond are XLA in the JAX package",
                "library": "torch.nonzero (a host read) and the parked "
                           "gather, after the flags",
                "launches_two_pass_auto": launches[
                    "two-pass select, two-pass auto flags"]}
               if key == "two-pass select" else {}),
            **({"tpu_kernel": "none: XLA's scatter-add, the transpose of "
                              "take_rows' gather, in the JAX package",
                "library": "torch.bincount(weights=) in float32, the "
                           "backwards' sum before the kernel",
                **{k: first[k] for k in (
                    "index_add_ms", "sort_ms", "lanes", "cols", "n_rows",
                    "path",
                    "kernel_rel_err", "kernel_plain_rel_err",
                    "bincount32_rel_err")}}
               if key == "scatter_rows" else {}),
        })
    kernels.append(rng_kernel_entry(rng_rows, launches["RNG"]))
    for k in kernels:
        if k["launches"] < 1:
            fail(f"{k['name']} was not launched on its main path")
        if k["ms"] < k["bound_ms"]:
            fail(f"{k['name']}: {k['ms']} ms reads under its bound "
                 f"{k['bound_ms']} ms")
    for rank in parallel["ranks"]:
        AUDIT.update(rank.get("audit", {}))
    log("[audit] float sums per audited backward (none may meet at one "
        "address) and the ops torch's deterministic mode flags: "
        + json.dumps(AUDIT))
    log(f"[time] total: {time.monotonic() - started:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
