"""Hold two checkouts of the port against each other on one card, in turns.

    python -m pathtracerpython_tpu_torch.compare_trees --other DIR \\
        [--out FILE] [--work DIR] [--cells NAME ...]
    python -m pathtracerpython_tpu_torch.compare_trees --worker TREE \\
        --out STEM [--cells NAME ...] [--no-renders]

``DIR`` is the root of another checkout (a ``git archive`` of the parent
commit, say). The checkout that holds this file is "change", the other
"parent". Each runs in its own process, which imports that checkout's
``pathtracerpython_tpu_torch`` and builds its kernels, in the order parent,
change, change, parent, so that a drift of the card or the host over the
call falls on both sides. Each run, for each cell (``--cells``: a subset,
by name; default all):

- times the nearest kernels on the first and second bounce wavefronts of
  the cell's batch_samples render (3 NEE samples), sorted and parked where
  the render sorts: on the Cornell stand-in (512x512, 4 spp) and the
  300-box field (512x512, 4 spp) the dense sweep (K1, and K3's dense
  nearest under ``mt_impl="plucker"``); on the 100k-triangle box field in
  morton order (512x512, 2 spp) the cluster walks K5 in blocks of 1024 and
  of 512, K3's sparse nearest in blocks of 512 and K8, and on the same
  wavefronts' shadow rays (the unfused NEE's, sorted and parked as the
  render does) the any-hits K6, K3's sparse any-hit, K9 and K7 on the full
  lists, and K7's two passes on the cache that a cold call returns (pass 1
  on its guess lists, pass 2 on the lanes pass 1 leaves open, compacted as
  the render compacts them). Each is the kernel's own launch with its
  pack, boxes and lists built beforehand, CUDA events, 3 samples of the
  mean of 20 launches after 3 warm-up launches. The ``probes`` cell times
  every variant of the probes P1 (262,144 rays x 512 triangles) and P2
  (2^20 rays x 512 triangles) so, on the probes' seeded inputs, their
  packs built beforehand; it renders nothing. The ``scatter`` cell times
  ``ops.gather.scatter_rows`` (the table gradients' sum, on the card
  csrc/scatter_rows.cu) on the calls one backward of the bench training
  step makes (the Cornell stand-in, 512x512, 4 spp as lanes, 4 bounces, 3
  NEE; captured), all of them in a row, on the 100k field's tri_v0
  backward of its primary rays, and on 2^20 x 9 lanes onto 3, 4, 113 and
  114 rows (the edges of the kernel's paths), with the float32 weighted
  bincount and index_add_ on the same inputs beside them, each timed with
  the stream held while the host queues the calls (device time), the
  kernel's calls also without and split by device kernel under
  torch.profiler; and profiles one
  backward of the bench step (device busy ms, device kernels, the top
  operators, aten::sort's ms and calls, and the device ms of the sum's own
  kernels and of any sort's); it renders nothing, and keeps
  that backward's gradients, which the comparison holds run against run.
  The ``two_pass`` cell times, on the 100k field's wavefronts, the select
  step on pass 1 of K5 (blocks of 512) and of K6 and the occluder cache's
  compaction of K7's open lanes, as each checkout runs them (the
  select-and-compact kernel csrc/two_pass.cu, or the finality kernel,
  torch.nonzero and the parked gather), unqueued and queued, and the
  two-pass and one-pass wrappers, and splits each select step's device
  time by device kernel under torch.profiler; its renders are the 100k
  field's sparse render with the occluder cache and its sparse and hybrid
  renders with both two-pass auto flags on;
- renders the cell with seed 0: the Cornell cell (512x512, 4 spp, 4
  bounces) and the boxfield300 cell (512x512, 2 spp, 3 bounces) in both
  forms, the Cornell cell also in reference mode and, in both modes,
  through ``parallel.render_sharded`` on a geometry ring of one rank; the 100k field (512x512, 2 spp, 3 bounces) through the hybrid,
  sparse, sparse with the occluder cache and walker hierarchies, and
  sparse and hybrid under ``mt_impl="plucker"``; for each render also the
  launches of every kernel in that render (the kernels' module counts,
  set to 0 just before) and, from one more render under
  ``torch.profiler``, the device busy ms (the device kernels' self time)
  and the number of device kernels.

``--worker`` makes one such run in checkout ``TREE`` alone, and writes
its times to ``STEM.json`` (with ``--no-renders`` it times the kernels
only): to time variants of one checkout, a copy with another constant,
say, run it once per tree in turns.

It prints, and writes to ``FILE`` as JSON, every run's times by wavefront,
the largest absolute difference of each render between every change run
and every parent run, and between the two runs of each checkout, and
each render's launches and device busy ms by run, with whether the
launches of all four runs are equal; with the ``scatter`` cell also its
profiled backward by run and the largest difference of its gradients
between every two runs. Needs a
CUDA device; nothing here runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORDER = ("parent", "change", "change", "parent")
FORMS = {"classic": {"mt_impl": "classic"}, "plucker": {"mt_impl": "plucker"}}
NEE_SAMPLES = 3
# name: (scene constructor and its keywords, pack keywords, spp of the
# timed wavefronts, render spp, render bounces, renders by name)
# renders of the Cornell cell beyond the two forms: reference mode, and
# both modes through render_sharded on a ring of one rank (the ring's code
# with no shift), which the port's sharded renders run
CORNELL_RENDERS = {**FORMS, "reference": {"mode": "reference"},
                   "ring": {"ring": True},
                   "ring reference": {"ring": True, "mode": "reference"}}
CELLS = {
    "cornell": (("cornell_box_scene", {}), {"pad_to": 32}, 4, 4, 4,
                CORNELL_RENDERS),
    "boxfield300": (("box_field_scene", {"n_boxes": 300}), {}, 4, 2, 3,
                    FORMS),
    "large100k": (("box_field_scene", {"n_boxes": 8333}),
                  {"tri_order": "morton"}, 2, 2, 3, {
                      "hybrid": {},
                      "sparse": {"accel": "sparse"},
                      "sparse+cache": {"accel": "sparse", "nee_cache": "on"},
                      "walker": {"accel": "walker"},
                      "sparse plucker": {"accel": "sparse",
                                         "mt_impl": "plucker"},
                      "hybrid plucker": {"mt_impl": "plucker"},
                  }),
    # the two-pass protocol and the occluder cache's compaction on the 100k
    # field: the select steps and the wrappers (_two_pass_steps), and the
    # renders that run them
    "two_pass": (("box_field_scene", {"n_boxes": 8333}),
                 {"tri_order": "morton"}, 2, 2, 3, {
                     "sparse+cache": {"accel": "sparse", "nee_cache": "on"},
                     "sparse two-pass": {"accel": "sparse",
                                         "two_pass_auto": True},
                     "hybrid two-pass": {"two_pass_auto": True},
                 }),
}
TWO_PASS = "two_pass"


# the cell of the probes P1 and P2 (kernel times only)
PROBES = "probes"
# the cell of the table gradients' sum (times, one profiled backward)
SCATTER = "scatter"
# the bench training step's params (chip_smoke.py STEP_FIELDS)
STEP_FIELDS = ("mat_rgb", "mat_ka", "mat_kd", "light_color", "ambient",
               "tri_v0", "tri_v1", "tri_v2", "light_v0", "light_v1",
               "light_v2")


def _scene(port, cell):
    (ctor, kw), pack_kw = CELLS[cell][:2]
    desc = getattr(port["scene.synthetic"], ctor)(width=512, height=512, **kw)
    return port["scene.arrays"].pack_scene(desc, **pack_kw)


def _wavefronts(port, scene, spp):
    """(o3, d3 unit, shadow rays) of the first and second bounce wavefronts
    of the scene's batch_samples render at ``spp``, as the render forms
    them (``integrator.ShadowRays``, the unfused NEE's)."""
    import torch

    rng, camera = port["ops.rng"], port["ops.camera"]
    geometry, integrator = port["ops.geometry"], port["render.integrator"]
    cfg = port["render.config"].RenderConfig(
        n_samples=spp, n_bounces=2, n_light_samples=NEE_SAMPLES,
        batch_samples=True)
    bounds = (port["ops.sort"].scene_bounds(scene)
              if integrator._sort_enabled(scene, cfg) else None)
    w, h = scene.meta.width, scene.meta.height
    origins, dirs = camera.make_primary_rays(scene.eye, scene.ortho, w, h)
    pid = torch.arange(w * h, device=scene.device)
    counters = torch.cat([pid * spp + s for s in range(spp)])
    state = integrator.init_rays(origins.T.repeat(1, spp),
                                 dirs.T.repeat(1, spp), counters)
    k0, k1 = rng.key_from_seed(0)
    out = []
    for b in range(2):
        st, o3, d3 = integrator.sort_and_park(state, bounds)
        nk = rng.fold(k0, k1, b * 4 + integrator._P_NEE)
        u_nee = rng.uniforms(*nk, st.counters, NEE_SAMPLES * 5)
        hit = geometry.nearest_hit_cm(o3, d3, scene, accel=cfg.accel)
        shading = integrator.arrival_side_normal(
            hit.normal3, geometry.normalize3(st.direction3))
        shadow = integrator.nee_shadow_rays(
            hit, u_nee, scene, cfg, shading,
            st.alive & hit.hit & ~hit.is_light, st.nee_occ_hint)
        out.append((o3.contiguous(), geometry.normalize3(d3).contiguous(),
                    shadow))
        state = integrator.bounce_step(state, b, scene, cfg, k0, k1, bounds)
    return out


def _dense_kernels(port, scene, o3, d3):
    """The checkout's dense nearest kernel in each form as ``fn()``, its
    pack and its boxes built beforehand."""
    intersect = port["kernels.intersect"]
    tripack = intersect.scene_tripack(scene)
    cull = intersect.nearest_cull_boxes(tripack)
    out = {}
    for form in ("classic", "plucker"):
        plucker = form == "plucker"
        pack = intersect.scene_plucker_pack(scene) if plucker else tripack
        launch = intersect._launch_plucker if plucker else intersect._launch
        out[form] = (lambda launch=launch, pack=pack:
                     launch(o3, d3, pack, cull))
    return out


def _walk_kernels(port, scene, o3, d3, shadow):
    """The checkout's cluster walks as ``fn()``, their packs, boxes and
    lists built beforehand: the nearest walks on the path rays, the
    any-hits on the ``shadow`` rays."""
    import torch

    intersect, sparse = port["kernels.intersect"], port["kernels.sparse"]
    walker = port["kernels.walker"]
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    pack36 = intersect.scene_plucker_pack(scene, sparse.PACK_ROWS)

    def lists(r_blk):
        nrb = -(-o3.shape[1] // r_blk)
        return sparse.block_lists(aabb8, o3, d3, torch.full(
            (nrb,), intersect.BIG, device=o3.device), r_blk)

    l1024, l512 = lists(1024), lists(512)
    lw = walker.nearest_lists(aabb8, o3, d3)
    so, sd, sm = (x.contiguous() for x in (shadow.o3, shadow.d3,
                                            shadow.maxd))
    s512 = sparse.window_lists(aabb8, so, sd, sm, sparse.R_BLK)
    sw = walker.walker_lists(aabb8, so, sd, sm)
    cull = sparse.scene_cluster_cull_boxes(scene)
    shadow_args = (so, sd, sm)
    # K7's passes on the cache a cold call returns, as the render's next
    # call runs them (the relevant lanes vote, the open ones go to pass 2)
    rel = shadow.relevant.contiguous()
    cold = torch.full((so.shape[1],), -1, dtype=torch.int32,
                      device=so.device)
    cache = sparse.sparse_any_hit_cached_cm(*shadow_args, scene, cold,
                                            relevant=rel)[1]
    k7 = lambda rays, lists: sparse._launch_any_hit_idx(
        *rays, tripack, aabb8, lists, sparse.R_BLK, cull)
    passes = [(p.rays, p.lists) for p in sparse.cached_passes(
        *shadow_args, tripack, aabb8, cull, cache, rel)[:2]]
    return {
        "K5@1024": lambda: sparse._launch(o3, d3, tripack, aabb8, l1024,
                                          1024),
        "K5@512": lambda: sparse._launch(o3, d3, tripack, aabb8, l512, 512),
        "K3 sparse nearest@512": lambda: sparse._launch_plucker(
            o3, d3, pack36, aabb8, l512, 512),
        "K8": lambda: walker._launch_nearest(o3, d3, tripack, aabb8, lw,
                                             walker.R_BLK),
        "K6": lambda: sparse._launch_any_hit(
            *shadow_args, tripack, aabb8, s512, sparse.R_BLK, cull),
        "K3 sparse any-hit": lambda: sparse._launch_plucker_any_hit(
            *shadow_args, pack36, aabb8, s512, sparse.R_BLK, cull),
        "K9": lambda: walker._launch(*shadow_args, tripack, aabb8, sw,
                                     walker.R_BLK, cull),
        "K7 full lists": lambda: k7(shadow_args, s512),
        "K7 pass 1": lambda: k7(*passes[0]),
        "K7 pass 2": lambda: k7(*passes[1]),
    }


def _two_pass_steps(port, scene, o3, d3, shadow):
    """The two-pass protocol's steps on the 100k field's wavefronts as the
    checkout runs them, as ``fn()``: the select step on pass 1 of K5 in
    blocks of 512 and of K6 (truncated to PASS1_K slots; lists, pass 1 and
    the scene's box made beforehand), and the occluder cache's compaction
    of K7's open lanes after a cold pass 1: a checkout with the
    select-and-compact kernel (csrc/two_pass.cu) runs it; one without runs
    the finality kernel, torch.nonzero and the parked gather. Then the
    two-pass wrappers (two_pass=4, the branch M_DIV takes) and the one-pass
    ones."""
    import torch

    intersect, sparse = port["kernels.intersect"], port["kernels.sparse"]
    tripack = sparse.pack_for_sparse(scene)
    aabb8 = sparse.cluster_aabbs(tripack)
    cull = sparse.scene_cluster_cull_boxes(scene)
    so, sd, sm = (x.contiguous() for x in (shadow.o3, shadow.d3,
                                            shadow.maxd))
    rel = shadow.relevant.contiguous()
    n, ns, r_blk = o3.shape[1], so.shape[1], sparse.R_BLK
    lists = sparse.block_lists(aabb8, o3, d3, torch.full(
        (-(-n // r_blk),), intersect.BIG, device=o3.device), r_blk)
    head, drops = sparse.truncate_lists(lists, sparse.PASS1_K)
    words = sparse.walk_words(n, o3.device)
    t1, i1 = sparse._launch(o3, d3, tripack, aabb8, head, r_blk, words=words)
    wl = sparse.window_lists(aabb8, so, sd, sm, r_blk)
    whead, wdrops = sparse.truncate_lists(wl, sparse.PASS1_K)
    occ1 = sparse._launch_any_hit(so, sd, sm, tripack, aabb8, whead, r_blk,
                                  cull)
    cold = torch.full((ns,), -1, dtype=torch.int32, device=so.device)
    k7 = sparse._launch_any_hit_idx(so, sd, sm, tripack, aabb8,
                                    sparse.guess_lists(cold, aabb8.shape[0]),
                                    r_blk, cull)[0]
    open_lanes = ~k7 & rel
    m, ms = sparse.pass2_size(n, r_blk), sparse.pass2_size(ns, r_blk)
    if hasattr(sparse, "select_compact"):
        box = sparse.scene_cluster_box(scene)
        steps = {
            "select nearest@512": lambda: sparse.nearest_select_compact(
                o3, d3, aabb8, box, drops, r_blk, t1, i1, words, m,
                lists.ncand),
            "select any-hit": lambda: sparse.any_hit_select_compact(
                so, sd, sm, occ1, aabb8, box, wdrops, r_blk, ms, wl.ncand),
            "compact K7 cold": lambda: sparse.select_compact(
                open_lanes, ms, so, sd, sm)}
    else:
        def compacted(flags, m, o, d, md):
            sel, cnt = sparse.two_pass_select(flags, m)
            if cnt <= m:
                sparse.parked_rays(o, d, md, sel, m)

        steps = {
            "select nearest@512": lambda: compacted(sparse.nearest_select(
                o3, d3, aabb8, drops, r_blk, t1, i1, words)[0], m, o3, d3,
                None),
            "select any-hit": lambda: compacted(sparse.any_hit_select(
                so, sd, sm, occ1, aabb8, wdrops, r_blk)[0], ms, so, sd, sm),
            "compact K7 cold": lambda: compacted(open_lanes, ms, so, sd,
                                                 sm)}
    for k in (0, 4):
        what = "two-pass" if k else "one-pass"
        for rb in (sparse.R_BLK_HYBRID_NEAREST, r_blk):
            steps[f"K5@{rb} {what} wrapper"] = (
                lambda k=k, rb=rb: sparse.sparse_nearest_t_idx_cm(
                    o3, d3, scene, r_blk=rb, two_pass=k))
        steps[f"K6 {what} wrapper"] = (
            lambda k=k: sparse.sparse_any_hit_cm(so, sd, sm, scene,
                                                 two_pass=k))
    return steps


def _probe_kernels(port):
    """Every variant of P1 and P2 as ``fn()`` at the probes' default sizes
    on their seeded inputs, P1's packs built beforehand (``make_packs``)."""
    mma, bf16 = port["probes.mma_probe"], port["probes.bf16_probe"]
    o3, d3, tripack = mma.make_inputs(262144, 512, 0, "cuda")
    packs = mma.make_packs(tripack)
    out = {f"P1 {v}": (lambda v=v: mma.probe(o3, d3, tripack, v, packs))
           for v in mma.VARIANTS}
    bo3, bd3, btri = bf16.make_inputs(1 << 20, 512, 0, "cuda")
    out.update({f"P2 {v}": (lambda v=v: bf16.hit_count(bo3, bd3, btri, v))
                for v in bf16.VARIANTS})
    return out


def _capture_scatters(port, fn) -> list:
    """Run ``fn()`` with every caller of ``scatter_rows`` recording its
    inputs (strides kept) in call order."""
    import torch

    calls = []
    modules = [port[m] for m in ("ops.gather", "kernels.intersect",
                                 "kernels.nee")]
    saved = [m.scatter_rows for m in modules]

    def recording(real):
        def record(values, rows, n_rows):
            calls.append((values.detach().clone(), rows.detach().clone(),
                          n_rows))
            return real(values, rows, n_rows)
        return record

    for m, real in zip(modules, saved):
        m.scatter_rows = recording(real)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        for m, real in zip(modules, saved):
            m.scatter_rows = real
    return calls


def _scatter_cell(port):
    """The ``scatter`` cell: ({name: fn()} to time, the bench step's
    ``loss()`` (fresh leaves and a forward -> (params, loss)))."""
    import dataclasses

    import torch

    gather = port["ops.gather"]
    diff = port["diff"]
    cornell = _scene(port, "cornell")
    cfg = port["render.config"].RenderConfig(
        mode="fast", n_samples=4, n_bounces=4, n_light_samples=NEE_SAMPLES,
        batch_samples=True)
    with torch.no_grad():
        target = port["render.integrator"].render(cornell, cfg, seed=0)
    start = {f: getattr(cornell, f).detach().clone() for f in STEP_FIELDS}
    start["mat_rgb"] = start["mat_rgb"] * 0.5
    pids = torch.arange(target.shape[0], device="cuda")
    render_fn = diff.make_render_fn(cfg)

    def loss():
        params = {k: v.clone().requires_grad_(True) for k, v in start.items()}
        return params, diff.camera_pixel_loss(params, cornell, target,
                                              render_fn, pids, (0, 5))

    def backward():
        params, value = loss()
        value.backward()

    step_calls = _capture_scatters(port, backward)
    labels = {}
    for v, r, n_rows in step_calls:
        labels.setdefault(f"bench step {v.shape[0]}x{v.shape[1]} onto "
                          f"{n_rows}" + ("" if v.is_contiguous()
                                         else " strided"), (v, r, n_rows))
    large = port["scene.arrays"].pack_scene(
        port["scene.synthetic"].box_field_scene(n_boxes=8333, width=512,
                                                height=512),
        tri_order="morton")
    geometry, camera = port["ops.geometry"], port["ops.camera"]
    o, d = camera.make_primary_rays(large.eye, large.ortho, 512, 512)
    o3, d3 = o.T.contiguous(), geometry.normalize3(d.T).contiguous()

    def tri_backward():
        leaves = {f: getattr(large, f).detach().clone().requires_grad_(True)
                  for f in ("tri_v0", "tri_v1", "tri_v2")}
        t = geometry.nearest_hit_cm(o3, d3, dataclasses.replace(
            large, **leaves), accel="auto").t
        gen = torch.Generator(device="cuda").manual_seed(3)
        t.backward(torch.randn(t.shape[0], generator=gen, device="cuda"))

    v, r, n_rows = next(c for c in _capture_scatters(port, tri_backward)
                        if c[2] == large.num_padded_triangles)
    labels[f"100k tri_v0 {v.shape[0]}x{v.shape[1]} onto {n_rows}"] = (
        v, r, n_rows)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for n_rows in (3, 4, 113, 114):
        u = torch.rand(2**20, generator=gen, device="cuda")
        labels[f"edge 1048576x9 onto {n_rows}"] = (
            torch.randn((2**20, 9), generator=gen, device="cuda"),
            (u * u * n_rows).to(torch.int64).clamp_max(n_rows - 1), n_rows)
    fns = {}
    for label, (v, r, n_rows) in labels.items():
        c = v.shape[1]
        bins = (r[:, None] * c + torch.arange(c, device="cuda")).reshape(-1)
        fns[f"{label} kernel"] = (lambda v=v, r=r, n=n_rows:
                                  gather.scatter_rows(v, r, n))
        fns[f"{label} bincount32"] = (
            lambda bins=bins, v=v, n=n_rows * c: torch.bincount(
                bins, weights=v.reshape(-1), minlength=n))
        fns[f"{label} index_add_"] = (
            lambda v=v, r=r, n=n_rows: torch.zeros(
                (n, v.shape[1]), device="cuda").index_add_(0, r, v))

    def all_step_calls():
        for v, r, n_rows in step_calls:
            gather.scatter_rows(v, r, n_rows)

    fns[f"bench step's {len(step_calls)} calls kernel"] = all_step_calls
    return fns, loss


def _kernel_split(fn, reps: int = 10) -> dict:
    """{device kernel: us a call} of ``fn()`` under torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:80]: e.self_device_time_total / reps
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def _profile_backward(loss) -> dict:
    """The backward of one ``loss()`` (its forward run before) under
    torch.profiler: device busy ms, device kernels, the top 6 aten
    operators by self device ms, aten::sort's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    loss()[1].backward()
    _, value = loss()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        value.backward()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.key.startswith("aten::")]
    sort = [e for e in ops if e.key == "aten::sort"]
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:6]
    # the device kernels of scatter_rows (either design) and of any sort
    mine = [e for e in kernels if any(w in e.key for w in (
        "tiny_kernel", "narrow_kernel", "grid_tree_kernel", "windows_kernel",
        "rows_kernel", "runs_kernel", "RadixSort", "radix_sort"))]
    return {"device_busy_ms": sum(e.self_device_time_total
                                  for e in kernels) / 1e3,
            "device_kernels": sum(e.count for e in kernels),
            "top_ops_ms": {e.key: [e.self_device_time_total / 1e3, e.count]
                           for e in top},
            "sort_ms": sum(e.self_device_time_total for e in sort) / 1e3,
            "sort_calls": sum(e.count for e in sort),
            "scatter_and_sort_kernels_ms": {
                e.key[:80]: [e.self_device_time_total / 1e3, e.count]
                for e in mine}}


def _ms(fn, reps: int = 20, queued: bool = False) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls by CUDA events. ``queued``:
    the stream is held by a spin kernel (about 0.25 ms a call) while the
    host queues the calls, so a call whose host side outlasts its device
    work reads its device time (a call that reads back to the host still
    waits for the device and reads as before)."""
    import torch

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


def _launch_counts(port) -> dict:
    """The kernels' launch counts (every module int named *LAUNCHES)."""
    return {f"{m.rsplit('.', 1)[1]}.{name}": value
            for m in ("kernels.intersect", "kernels.nee", "kernels.sparse",
                      "kernels.walker")
            for name, value in vars(port[m]).items()
            if name.endswith("LAUNCHES") and isinstance(value, int)}


def _render_record(port, render) -> dict:
    """``render()``'s launches (the counts set to 0 just before), and the
    device busy ms and device kernels of one more ``render()`` under
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for key in _launch_counts(port):
        module, name = key.split(".")
        setattr(port[f"kernels.{module}"], name, 0)
    render()
    torch.cuda.synchronize()
    launches = _launch_counts(port)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    return {"launches": launches,
            "device_busy_ms": sum(e.self_device_time_total
                                  for e in kernels) / 1e3,
            "device_kernels": sum(e.count for e in kernels)}


def _render_fn(port, scene, spp: int, bounces: int, kw: dict):
    """``render()`` of the scene with seed 0 under the config ``kw``
    (``ring``: through ``render_sharded`` on a ring of one rank)."""
    kw = dict(kw)
    ring = kw.pop("ring", False)
    auto = kw.pop("two_pass_auto", False)
    cfg = port["render.config"].RenderConfig(**{
        "mode": "fast", "n_samples": spp, "n_bounces": bounces,
        "n_light_samples": NEE_SAMPLES, "batch_samples": True, **kw})
    if auto:
        sparse = port["kernels.sparse"]

        def render():
            # both two-pass auto flags on, as scripts/bench_large.py turns
            # them on in the JAX package; restored after
            before = sparse.TWO_PASS_NEAREST_AUTO, sparse.TWO_PASS_ANY_AUTO
            sparse.TWO_PASS_NEAREST_AUTO = sparse.TWO_PASS_ANY_AUTO = True
            try:
                return port["render.integrator"].render(scene, cfg, seed=0)
            finally:
                (sparse.TWO_PASS_NEAREST_AUTO,
                 sparse.TWO_PASS_ANY_AUTO) = before

        return render
    if ring:
        parallel = port["parallel"]
        mesh = parallel.make_mesh()
        return lambda: parallel.render_sharded(scene, cfg, mesh, seed=0,
                                               geom_axis="geom")
    return lambda: port["render.integrator"].render(scene, cfg, seed=0)


def worker(tree: str, out: str, cells, renders: bool = True) -> None:
    """One run in one checkout: times to ``out`` + ".json", renders (unless
    ``renders`` is False) to ``out`` + "_<cell>_<render>.pt"."""
    sys.path[0] = tree   # not this file's directory, inside a package
    import importlib

    import torch

    import pathtracerpython_tpu_torch as pkg

    if not os.path.abspath(pkg.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {pkg.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the comparison runs on the card")
    port = {m: importlib.import_module(f"pathtracerpython_tpu_torch.{m}")
            for m in ("kernels.intersect", "kernels.nee", "kernels.sparse",
                      "kernels.walker", "ops.rng", "ops.camera",
                      "ops.gather", "ops.geometry", "ops.sort", "parallel",
                      "diff",
                      "probes.bf16_probe", "probes.mma_probe",
                      "render.config", "render.integrator",
                      "scene.arrays", "scene.synthetic")}
    times, records, profiles = {}, {}, {}
    for cell in cells:
        if cell == SCATTER:
            fns, loss = _scatter_cell(port)
            for name, run in fns.items():
                for _ in range(3):
                    run()
                times[f"{cell} {name}"] = [_ms(run, queued=True)
                                           for _ in range(3)]
                if name.endswith(" kernel"):
                    times[f"{cell} {name} unqueued"] = [_ms(run)
                                                        for _ in range(3)]
                    profiles[f"{name} split us"] = _kernel_split(run)
            params, value = loss()
            value.backward()
            torch.save({k: p.grad.cpu() for k, p in params.items()},
                       f"{out}_{cell}_grads.pt")
            profiles["bench step backward"] = _profile_backward(loss)
            del fns, loss, params, value
            torch.cuda.empty_cache()
            continue
        if cell == PROBES:
            for name, run in _probe_kernels(port).items():
                for _ in range(3):
                    run()
                times[f"{cell} {name}"] = [_ms(run) for _ in range(3)]
            continue
        scene = _scene(port, cell)
        _, _, wave_spp, spp, bounces, cell_renders = CELLS[cell]
        for b, (o3, d3, shadow) in enumerate(
                _wavefronts(port, scene, wave_spp), start=1):
            if cell == TWO_PASS:
                kernels = _two_pass_steps(port, scene, o3, d3, shadow)
            elif cell == "large100k":
                kernels = _walk_kernels(port, scene, o3, d3, shadow)
            else:
                kernels = _dense_kernels(port, scene, o3, d3)
            for name, run in kernels.items():
                for _ in range(3):
                    run()
                times[f"{cell} bounce {b} {name}"] = [_ms(run)
                                                      for _ in range(3)]
                if cell == TWO_PASS and not name.endswith("wrapper"):
                    times[f"{cell} bounce {b} {name} queued"] = [
                        _ms(run, queued=True) for _ in range(3)]
                    profiles[f"bounce {b} {name} split us"] = _kernel_split(
                        run)
        for name, kw in (cell_renders if renders else {}).items():
            render = _render_fn(port, scene, spp, bounces, kw)
            torch.save(render().cpu(), f"{out}_{cell}_{name}.pt")
            records[f"{cell} {name}"] = _render_record(port, render)
        del scene
        torch.cuda.empty_cache()
    with open(out + ".json", "w") as f:
        json.dump({"times": times, "renders": records,
                   "profiles": profiles}, f)


def compare(other: str, work: str, cells) -> dict:
    import torch

    os.makedirs(work, exist_ok=True)
    trees = {"parent": os.path.abspath(other), "change": THIS_ROOT}
    runs = []
    for k, side in enumerate(ORDER):
        out = os.path.join(work, f"run{k}_{side}")
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--worker", trees[side], "--out", out, "--cells",
                        *cells], check=True)
        with open(out + ".json") as f:
            runs.append((side, out, json.load(f)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    result = {"card": smi, "order": list(ORDER), "kernel_ms": {},
              "radiance_max_abs_diff": {}, "renders": {},
              "profiles": {key: [r.get("profiles", {}).get(key)
                                 for _, _, r in runs]
                           for key in runs[0][2].get("profiles", {})}}
    for key, record in runs[0][2]["renders"].items():
        per_run = [r["renders"][key] for _, _, r in runs]
        result["renders"][key] = {
            "launches_equal": all(r["launches"] == record["launches"]
                                  for r in per_run),
            "launches": record["launches"],
            "device_busy_ms": [r["device_busy_ms"] for r in per_run],
            "device_kernels": [r["device_kernels"] for r in per_run],
        }
    runs = [(side, out, r["times"]) for side, out, r in runs]
    for key in runs[0][2]:
        result["kernel_ms"][key] = {
            side: [t for s, _, r in runs if s == side for t in r[key]]
            for side in ("parent", "change")}
        result["kernel_ms"][key]["median"] = {
            side: statistics.median(v)
            for side, v in result["kernel_ms"][key].items()}
    if SCATTER in cells:
        grads = [(side, torch.load(f"{out}_{SCATTER}_grads.pt"))
                 for side, out, _ in runs]
        result["scatter_grads_max_abs_diff"] = {
            f"run{i} {si} - run{j} {sj}": max(
                (gi[k] - gj[k]).abs().max().item() for k in gi)
            for i, (si, gi) in enumerate(grads)
            for j, (sj, gj) in enumerate(grads[i + 1:], start=i + 1)}
    for cell in (c for c in cells if c not in (PROBES, SCATTER)):
        for name in CELLS[cell][5]:
            rad = [(side, torch.load(f"{out}_{cell}_{name}.pt"))
                   for side, out, _ in runs]
            diffs = {}
            for i, (si, ri) in enumerate(rad):
                for j, (sj, rj) in enumerate(rad[i + 1:], start=i + 1):
                    diffs[f"run{i} {si} - run{j} {sj}"] = (
                        ri - rj).abs().max().item()
            result["radiance_max_abs_diff"][f"{cell} {name}"] = diffs
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the other (parent) checkout")
    ap.add_argument("--out", help="write the result here as JSON")
    ap.add_argument("--work", default=os.path.join(THIS_ROOT, "build",
                                                   "compare_trees"),
                    help="directory for the runs' files")
    ap.add_argument("--cells", nargs="+", choices=[*CELLS, PROBES, SCATTER],
                    default=[*CELLS, PROBES, SCATTER],
                    help="the cells to compare")
    ap.add_argument("--worker", metavar="TREE",
                    help="one run in checkout TREE (times to OUT.json)")
    ap.add_argument("--no-renders", action="store_true",
                    help="with --worker: time the kernels only")
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.out, args.cells, not args.no_renders)
        return
    if not args.other:
        ap.error("--other is required")
    result = compare(args.other, args.work, args.cells)
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
