"""The table gradients' sum, ``ops/gather.py:scatter_rows``, on the CPU:
its plain version (``scatter_rows_plain``, the CPU path) and the model of
the card kernel's order (``scatter_rows_model``, which the card holds
csrc/scatter_rows.cu to bit for bit) against the JAX package's own
scatter-add, the gradient of ``pathtracerpython_tpu.ops.gather.take_rows``
and of ``cm_take`` (``jax.vjp``), and against the float64 sum; the
gathers ``take_rows`` / ``cm_take`` and their backwards; the C entry's
argument types and the kernel's constants; and the audit that finds the
float sums whose order the device would choose, over one backward of the
train step and of the soft cluster sweep. The kernel itself runs on the
card (``tests/test_torch_cuda.py``).

Tolerance: each entry of a sum within 1e-6 of the float64 sum, relative to
the sum of the absolute values that entry adds (float32 rounding over these
lane counts stays under 2e-7 of it)."""

from __future__ import annotations

import ctypes
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.ops import gather as jax_gather
from pathtracerpython_tpu_torch.kernels import build
from pathtracerpython_tpu_torch.ops import gather
from pathtracerpython_tpu_torch.utils.determinism import SumAudit

REL_TOL = 1e-6
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (lanes, columns, rows, how the lanes pick their rows): the bench step's
# three shapes at a small N (mat_rgb, the tripack, the light table), then
# the edges the kernel's paths meet (``gather.plan``: tiny up to TINY_SLOTS
# = 32 entries, narrow up to NARROW_SLOTS = 1024, wide past it)
CASES = {
    "mat_rgb": (4096, 3, 8, "skewed"),
    "tripack": (4096, 9, 64, "skewed"),
    "light_table": (3 * 1024, 9, 2, "uniform"),
    "two_rows_3x4096": (3 * 4096, 9, 2, "uniform"),
    "rows_100096": (20000, 9, 100096, "uniform"),
    "no_lanes": (0, 9, 5, "uniform"),
    "one_row": (777, 3, 1, "uniform"),
    "every_lane_one_row": (5000, 9, 7, "one"),
    "ragged_1007": (1007, 9, 64, "skewed"),
    "one_lane": (1, 12, 3, "uniform"),
    "tiny_edge_27": (3000, 9, 3, "skewed"),
    "narrow_past_tiny_36": (3000, 9, 4, "skewed"),
    "narrow_edge_1017": (3000, 9, 113, "skewed"),
    "wide_past_narrow_1026": (3000, 9, 114, "skewed"),
    "one_column": (3000, 1, 20, "skewed"),
    "tiny_widest_32": (1500, 32, 1, "uniform"),
    "narrow_33_columns": (1500, 33, 2, "skewed"),
    "wide_33_columns": (1500, 33, 40, "skewed"),
    "wide_one_row_of_many": (3000, 9, 500, "one"),
    "wide_skewed_empty_rows": (4000, 3, 2000, "skewed"),
}
# path each case must take: the cases above cover all three
PATHS = {"mat_rgb": "tiny", "light_table": "tiny", "tiny_edge_27": "tiny",
         "tiny_widest_32": "tiny", "tripack": "narrow",
         "narrow_past_tiny_36": "narrow", "narrow_edge_1017": "narrow",
         "narrow_33_columns": "narrow", "rows_100096": "wide",
         "wide_past_narrow_1026": "wide", "wide_33_columns": "wide"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: with one intra-op thread these tests take
    the same time alone and do not fight the other test workers for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(case: str, seed: int = 0):
    """(values f32[N, C], rows i64[N], n_rows) as numpy, from a seed; a
    skewed case gives low rows many more lanes (a wall that most rays
    hit), as a wavefront gives a scene's big triangles."""
    n, c, n_rows, how = CASES[case]
    rng = np.random.default_rng(seed)
    values = rng.standard_normal((n, c)).astype(np.float32)
    if how == "skewed":
        rows = np.minimum((rng.exponential(n_rows / 6, n)).astype(np.int64),
                          n_rows - 1)
    elif how == "one":
        rows = np.full(n, n_rows // 2, np.int64)
    else:
        rows = rng.integers(0, n_rows, n)
    return values, rows, n_rows


def _hold(got, values, rows, n_rows, what):
    """Each entry of ``got`` within REL_TOL of the float64 sum, relative to
    the sum of the absolute values it adds."""
    exact = np.zeros((n_rows, values.shape[1]))
    np.add.at(exact, rows, values.astype(np.float64))
    scale = np.zeros_like(exact)
    np.add.at(scale, rows, np.abs(values.astype(np.float64)))
    got = np.asarray(got, np.float64)
    assert got.shape == exact.shape, what
    err = np.abs(got - exact)
    assert np.all(err <= REL_TOL * scale), (
        what, float((err / np.maximum(scale, 1e-30)).max()))


def _jax_take_rows_grad(values, rows, n_rows):
    table = jnp.zeros((n_rows, values.shape[1]), jnp.float32)
    _, vjp = jax.vjp(lambda t: jax_gather.take_rows(t, jnp.asarray(rows)),
                     table)
    return np.asarray(vjp(jnp.asarray(values))[0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_and_model_match_jax_scatter_add(case):
    """The plain version and the kernel's order against the JAX package's
    scatter-add (the transpose of ``take_rows``) and the float64 sum; the
    dispatcher on a CPU tensor is the plain version bit for bit."""
    values, rows, n_rows = _inputs(case)
    v, r = torch.from_numpy(values), torch.from_numpy(rows)
    want = _jax_take_rows_grad(values, rows, n_rows)
    _hold(want, values, rows, n_rows, "jax")
    plain = gather.scatter_rows_plain(v, r, n_rows)
    model = gather.scatter_rows_model(v, r, n_rows)
    for name, got in (("plain", plain), ("model", model)):
        assert got.dtype == torch.float32, name
        _hold(got.numpy(), values, rows, n_rows, name)
        scale = np.zeros_like(want, np.float64)
        np.add.at(scale, rows, np.abs(values.astype(np.float64)))
        assert np.all(np.abs(got.numpy() - want) <= REL_TOL * scale), name
    assert torch.equal(gather.scatter_rows(v, r, n_rows), plain)


@pytest.mark.parametrize("case", ["mat_rgb", "tripack", "light_table",
                                  "one_row"])
def test_cm_take_gradient_matches_jax(case):
    """``cm_take`` on a [C, R] table that requires grad runs under
    ``TakeColumns``: its forward is the lookup and its backward the JAX
    package's ``cm_take`` gradient (a one-hot matmul's transpose there)."""
    values, rows, n_rows = _inputs(case, seed=1)
    rng = np.random.default_rng(2)
    table = rng.standard_normal((values.shape[1], n_rows)).astype(np.float32)
    idx = rows.reshape(-1, 4) if rows.size % 4 == 0 else rows
    cot = values.T.reshape((values.shape[1],) + idx.shape)
    out, vjp = jax.vjp(lambda t: jax_gather.cm_take(t, jnp.asarray(idx)),
                       jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    t = torch.from_numpy(table).requires_grad_(True)
    got = gather.cm_take(t, torch.from_numpy(idx))
    assert torch.equal(got.detach(), torch.from_numpy(np.array(out)))
    got.backward(torch.from_numpy(np.ascontiguousarray(cot)))
    _hold(t.grad.numpy().T, values, rows, n_rows, "cm_take")
    _hold(want.T, values, rows, n_rows, "jax cm_take")


def test_take_rows_matches_jax():
    """``take_rows`` of a [R, 3] table: the lookup, and under ``TakeRows``
    the JAX package's ``take_rows`` gradient, for an index of any shape; a
    table that needs no grad takes the plain gather."""
    rng = np.random.default_rng(3)
    table = rng.standard_normal((50, 3)).astype(np.float32)
    idx = rng.integers(0, 50, (40, 7))
    cot = rng.standard_normal((40, 7, 3)).astype(np.float32)
    out, vjp = jax.vjp(lambda t: jax_gather.take_rows(t, jnp.asarray(idx)),
                       jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_(True)
    got = gather.take_rows(t, torch.from_numpy(idx))
    assert "TakeRows" in type(got.grad_fn.next_functions[0][0]).__name__
    assert torch.equal(got.detach(), torch.from_numpy(np.array(out)))
    got.backward(torch.from_numpy(cot))
    _hold(t.grad.numpy(), cot.reshape(-1, 3), idx.reshape(-1), 50, "take_rows")
    _hold(np.asarray(vjp(jnp.asarray(cot))[0]), cot.reshape(-1, 3),
          idx.reshape(-1), 50, "jax take_rows")
    plain = gather.take_rows(torch.from_numpy(table), torch.from_numpy(idx))
    assert plain.grad_fn is None and torch.equal(plain, got.detach())


def test_model_is_the_kernels_order_at_the_bench_shapes():
    """At the bench step's full sizes (2^20 lanes onto a few materials and
    onto 64 pack rows, 3 x 2^20 shadow lanes onto the 2 light triangles),
    the kernel's order is within the bound of the float64 sum, and a
    strided [N, C] view (``TakeColumns`` passes the transposed gradient)
    gives the same bits as its contiguous copy."""
    rng = np.random.default_rng(4)
    for n, c, n_rows in ((2**20, 3, 8), (2**20, 9, 64), (3 * 2**20, 9, 2)):
        values = rng.standard_normal((n, c)).astype(np.float32)
        rows = np.minimum(rng.exponential(n_rows / 6, n).astype(np.int64),
                          n_rows - 1)
        got = gather.scatter_rows_model(torch.from_numpy(values),
                                        torch.from_numpy(rows), n_rows)
        _hold(got.numpy(), values, rows, n_rows, f"{n}x{c} onto {n_rows}")
    strided = torch.from_numpy(np.ascontiguousarray(values.T)).T
    assert not strided.is_contiguous()
    assert torch.equal(
        gather.scatter_rows_model(strided, torch.from_numpy(rows), n_rows),
        got)


def test_model_order_is_fixed_by_the_inputs():
    """The same inputs give the same bits; the lanes permuted (so each
    row's lanes enter in another order) give a sum within the bound, the
    bits moved by rounding at most."""
    values, rows, n_rows = _inputs("tripack", seed=5)
    v, r = torch.from_numpy(values), torch.from_numpy(rows)
    a = gather.scatter_rows_model(v, r, n_rows)
    assert torch.equal(a, gather.scatter_rows_model(v.clone(), r.clone(),
                                                    n_rows))
    perm = torch.from_numpy(np.random.default_rng(6).permutation(len(rows)))
    b = gather.scatter_rows_model(v[perm], r[perm], n_rows)
    _hold(b.numpy(), values, rows, n_rows, "permuted lanes")


def _emulate_kernel(values, rows, n_rows):
    """csrc/scatter_rows.cu's loops transcribed one add at a time in numpy
    float32 (a thread's or a warp's serial adds, the shuffle-down trees
    lane by lane, the wide path's segmented scan with its shuffles, the
    row ends the windows write and their owners read), independent of the
    vectorised model; small inputs only."""
    f32 = np.float32
    n, c = values.shape
    out = np.zeros((n_rows, c), f32)
    if n == 0:
        return out

    def warp_tree(x):                      # x: 32 lanes -> lane 0
        x = list(x)
        off = 16
        while off:
            x = [f32(x[i] + x[i + off]) if i + off < 32 else x[i]
                 for i in range(32)]
            off //= 2
        return x[0]

    def warps_tree(x):
        x = list(x)
        h = len(x) // 2
        while h:
            x = [f32(x[i] + x[i + h]) for i in range(h)]
            h //= 2
        return x[0]

    path, blocks, rpb = gather.plan(n, c, n_rows)
    t_n, w_n = gather.THREADS, gather.WARPS
    slots = n_rows * c

    def key(lane, end):
        if lane >= end:
            return -1
        r = int(rows[lane])
        return r if 0 <= r < n_rows else -1

    if path != "wide":
        part = np.zeros((blocks, slots), f32)
        for b in range(blocks):
            first = b * rpb * t_n
            end = min(first + rpb * t_n, n)
            if path == "tiny":
                acc = np.zeros((t_n, slots), f32)
                for t in range(t_n):
                    for q in range(rpb):
                        lane = first + q * t_n + t
                        k = key(lane, end)
                        for j in range(c if k >= 0 else 0):
                            acc[t, k * c + j] = f32(acc[t, k * c + j]
                                                    + values[lane, j])
                sums = [warp_tree(acc[32 * w:32 * w + 32, s])
                        for w in range(w_n) for s in range(slots)]
                sums = np.array(sums, f32).reshape(w_n, slots)
            else:
                table = np.zeros((w_n, slots), f32)
                for w in range(w_n):
                    for q in range(rpb):
                        step = first + w * 32 + q * t_n
                        ks = [key(step + lane, end) for lane in range(32)]
                        for k in sorted(set(ks) - {-1}):
                            peers = [lane for lane in range(32)
                                     if ks[lane] == k]
                            for j in range(c):
                                a = table[w, k * c + j]
                                for lane in peers:
                                    a = f32(a + values[step + lane, j])
                                table[w, k * c + j] = a
                sums = table
            part[b] = [warps_tree(sums[:, s]) for s in range(slots)]
        for e in range(slots):
            lanes = np.zeros(32, f32)
            for j in range(32):
                for b in range(j, blocks, 32):
                    lanes[j] = f32(lanes[j] + part[b, e])
            out.reshape(-1)[e] = warp_tree(lanes)
        return out

    order = np.argsort(rows.astype(np.int32), kind="stable")
    keys = rows.astype(np.int32)[order]
    windows = -(-n // 32)
    part = np.zeros((windows, 2, c), f32)
    row_end = {}
    int_min = np.iinfo(np.int32).min
    for w in range(windows):
        p0 = 32 * w
        k = [int(keys[p0 + i]) if p0 + i < n else int_min for i in range(32)]
        in_table = [p0 + i < n and 0 <= k[i] < n_rows for i in range(32)]
        head = [max(h for h in range(i + 1) if h == 0 or k[h] != k[h - 1])
                for i in range(32)]
        starts0 = p0 == 0 or int(keys[p0 - 1]) != k[0]
        goes_on = p0 + 32 < n and int(keys[p0 + 32]) == k[31]
        x = np.array([[values[order[p0 + i], j] if in_table[i] else f32(0)
                       for j in range(c)] for i in range(32)], f32)
        off = 1
        while off < 32:            # every lane reads its neighbour's old x
            x = np.array([[f32(x[i - off, j] + x[i, j]) if i - off >= head[i]
                           else x[i, j] for j in range(c)]
                          for i in range(32)], f32)
            off *= 2
        for i in range(32):
            if not in_table[i] or not (i == 31 or k[i] != k[i + 1]):
                continue
            if head[i] == 0 and not starts0 and not (i == 31 and goes_on):
                row_end[k[i]] = p0 + i + 1
            if (head[i] > 0 or starts0) and not (i == 31 and goes_on):
                out[k[i]] = x[i]
                continue
            if head[i] == 0:
                part[w, 0] = x[i]
            if i == 31:
                part[w, 1] = x[i]
    for w in range(windows):
        nxt = 32 * w + 32
        if nxt >= n:
            continue
        k = int(keys[nxt - 1])
        if not 0 <= k < n_rows or int(keys[nxt]) != k:
            continue
        if w > 0 and int(keys[32 * w]) == k and int(keys[32 * w - 1]) == k:
            continue
        m = (row_end[k] - 1) // 32 - w + 1
        for j in range(c):
            lanes = np.zeros(32, f32)
            for lane in range(32):
                for i in range(lane, m, 32):
                    lanes[lane] = f32(lanes[lane]
                                      + part[w + i, 1 if i == 0 else 0, j])
            out[k, j] = warp_tree(lanes)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_model_is_the_kernels_loops(case):
    """The vectorised model gives, bit for bit, what the kernel's loops
    give when run one add at a time (``_emulate_kernel``); on the path the
    case is meant to take; and a component-major [N, C] view, as
    TakeColumns hands over, gives its contiguous copy's bits."""
    values, rows, n_rows = _inputs(case, seed=7)
    n, c = values.shape
    if case in PATHS:
        assert gather.plan(n, c, n_rows)[0] == PATHS[case]
    v, r = torch.from_numpy(values), torch.from_numpy(rows)
    model = gather.scatter_rows_model(v, r, n_rows)
    assert np.array_equal(model.numpy().view(np.int32),
                          _emulate_kernel(values, rows, n_rows).view(np.int32))
    strided = torch.from_numpy(np.ascontiguousarray(values.T)).T
    assert torch.equal(gather.scatter_rows_model(strided, r, n_rows), model)


@pytest.mark.parametrize("path,lanes,cols,n_rows", [
    ("tiny", 2 * gather.GRID * gather.THREADS + 7, 1, 5),
    ("narrow", gather.GRID * gather.THREADS + 300, 1, 40),
])
def test_model_is_the_kernels_loops_over_many_rounds(path, lanes, cols,
                                                     n_rows):
    """Past GRID x THREADS lanes each narrow block takes several rounds
    (and the last block fewer): the model against the kernel's loops
    there, one column (so the one-add-at-a-time loops stay short)."""
    rng = np.random.default_rng(8)
    values = rng.standard_normal((lanes, cols)).astype(np.float32)
    rows = np.minimum(rng.exponential(n_rows / 6, lanes).astype(np.int64),
                      n_rows - 1)
    got_path, blocks, rpb = gather.plan(lanes, cols, n_rows)
    assert got_path == path and rpb > 1 and blocks <= gather.GRID
    model = gather.scatter_rows_model(torch.from_numpy(values),
                                      torch.from_numpy(rows), n_rows)
    _hold(model.numpy(), values, rows, n_rows, path)
    assert np.array_equal(model.numpy().view(np.int32),
                          _emulate_kernel(values, rows, n_rows).view(np.int32))


def test_plan_follows_the_table_and_the_lanes():
    """The path follows n_rows * C alone (tiny up to TINY_SLOTS, narrow up
    to NARROW_SLOTS, wide past it); a narrow grid is at most GRID blocks,
    none of them empty, each of rpb rounds of THREADS lanes."""
    for n_rows, c, path in ((2, 9, "tiny"), (32, 1, "tiny"), (8, 4, "tiny"),
                            (33, 1, "narrow"), (64, 9, "narrow"),
                            (1024, 1, "narrow"), (1025, 1, "wide"),
                            (100096, 9, "wide")):
        assert gather.plan(1000, c, n_rows)[0] == path, (n_rows, c)
    for n in (1, 255, 256, 257, 135168, 135169, 3 * 2**20, 2**31 - 1):
        _, blocks, rpb = gather.plan(n, 9, 2)
        rounds = -(-n // gather.THREADS)
        assert blocks <= gather.GRID and (blocks - 1) * rpb < rounds \
            <= blocks * rpb, n


def test_cuda_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the kernel's wrapper raises: the dispatcher takes the
    plain version only because the tensor lies on the CPU, and nothing
    falls back."""
    v, r = torch.zeros((4, 3)), torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="one card"):
        gather.scatter_rows_cuda(v, r, 2)


def test_entry_signature_and_constants_match():
    """``gather._ARGTYPES`` follows ``ptt_scatter_rows``'s parameters (a
    pointer for each pointer, a long long for each long long, an int for
    each int), and THREADS / GRID / TINY_SLOTS / NARROW_SLOTS / WINDOW,
    which the model's paths, grids and order follow, are the kernel's
    constants."""
    with open(os.path.join(build.CSRC_DIR, "scatter_rows.cu")) as f:
        text = f.read()
    head = text.index('extern "C" int ptt_scatter_rows(')
    params = [" ".join(p.split()) for p in
              text[text.index("(", head) + 1:text.index(")", head)].split(",")]
    assert len(params) == len(gather._ARGTYPES), params
    for decl, argtype in zip(params, gather._ARGTYPES):
        want = (ctypes.c_void_p if "*" in decl else ctypes.c_longlong
                if decl.startswith("long long") else ctypes.c_int)
        assert argtype is want, (decl, argtype)
    for name, value in (("kThreads", gather.THREADS), ("kGrid", gather.GRID),
                        ("kTinySlots", gather.TINY_SLOTS),
                        ("kNarrowSlots", gather.NARROW_SLOTS),
                        ("kWindow", gather.WINDOW)):
        decl = text[text.index(f"constexpr int {name} = "):].split(";")[0]
        assert int(decl.split("=")[1]) == value, name
    assert gather.WARPS * 32 == gather.THREADS
    code = "\n".join(line.split("//")[0] for line in text.splitlines())
    assert "atomic" not in code.lower(), "the kernel uses no atomics"


def test_package_never_sets_the_deterministic_flag():
    """The package changes no caller's torch state: no module of it calls
    ``torch.use_deterministic_algorithms`` (it would make a weighted
    ``bincount`` raise everywhere)."""
    pkg = os.path.join(ROOT, "pathtracerpython_tpu_torch")
    for base, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(base, name)) as f:
                    assert "use_deterministic_algorithms(" not in f.read(), \
                        name


def _audited_backward(scene, cfg, fields, monkeypatch) -> SumAudit:
    """One forward and backward of ``camera_pixel_loss`` under ``SumAudit``,
    with the plain version's own ``bincount`` (the CPU path of
    ``scatter_rows``, which the card replaces by the kernel) left out."""
    from pathtracerpython_tpu_torch.diff import (
        camera_pixel_loss,
        make_render_fn,
    )
    from pathtracerpython_tpu_torch.render.integrator import render

    calls = []
    plain = gather.scatter_rows_plain

    def kernel_stand_in(values, rows, n_rows):
        calls.append(values.shape)
        with torch._C._DisableTorchDispatch():
            return plain(values, rows, n_rows)

    monkeypatch.setattr(gather, "scatter_rows_plain", kernel_stand_in)
    with torch.no_grad():
        target = render(scene, cfg, seed=0)
    params = {f: getattr(scene, f).detach().clone().requires_grad_(True)
              for f in fields}
    with SumAudit() as audit:
        camera_pixel_loss(params, scene, target, make_render_fn(cfg),
                          torch.arange(target.shape[0]), (0, 5)).backward()
    assert calls and audit.backward_ops > 0
    return audit


@pytest.mark.parametrize("path", ["train_step", "soft_cluster"])
def test_no_gradient_path_sums_lanes_into_one_address(path, monkeypatch):
    """One backward of the train step (the Cornell stand-in, every
    material, emission and vertex field) and of the soft cluster sweep (a
    400-box field past SOFT_ACCEL_MIN_TRIS, ``tri_v0``): every float
    scatter-add left besides ``scatter_rows`` writes distinct addresses
    (the sort's permutations, a gather of one column per row), so none adds
    in an order the device chooses."""
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import (
        box_field_scene,
        cornell_box_scene,
    )

    if path == "train_step":
        scene = pack_scene(cornell_box_scene(16, 16), pad_to=32, device="cpu")
        cfg = RenderConfig(n_samples=2, n_bounces=2, n_light_samples=3,
                           batch_samples=True)
        fields = ("mat_rgb", "mat_ka", "mat_kd", "light_color", "ambient",
                  "tri_v0", "tri_v1", "tri_v2", "light_v0", "light_v1",
                  "light_v2")
    else:
        scene = pack_scene(box_field_scene(n_boxes=400, width=12, height=12),
                           tri_order="morton", device="cpu")
        cfg = RenderConfig(n_samples=1, n_bounces=1, soft_vis_beta=0.03)
        fields = ("tri_v0",)
    audit = _audited_backward(scene, cfg, fields, monkeypatch)
    assert not audit.shared, audit.report()
