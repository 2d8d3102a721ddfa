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
# the edges the kernel's levels meet
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
}


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


def test_cuda_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the kernel's wrapper raises: the dispatcher takes the
    plain version only because the tensor lies on the CPU, and nothing
    falls back."""
    v, r = torch.zeros((4, 3)), torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="one card"):
        gather.scatter_rows_cuda(v, r, 2)


def test_entry_signature_and_constants_match():
    """``gather._ARGTYPES`` follows ``ptt_scatter_rows``'s parameters (a
    pointer for each pointer, an int for each int), and RUN / TINY_ROWS /
    TINY_THREADS / ROW_THREADS, which the model's order follows, are the
    kernel's constants."""
    with open(os.path.join(build.CSRC_DIR, "scatter_rows.cu")) as f:
        text = f.read()
    head = text.index('extern "C" int ptt_scatter_rows(')
    params = [" ".join(p.split()) for p in
              text[text.index("(", head) + 1:text.index(")", head)].split(",")]
    assert len(params) == len(gather._ARGTYPES), params
    for decl, argtype in zip(params, gather._ARGTYPES):
        want = ctypes.c_void_p if "*" in decl else ctypes.c_int
        assert argtype is want, (decl, argtype)
    for name, value in (("kRun", gather.RUN), ("kTinyRows", gather.TINY_ROWS),
                        ("kTinyThreads", gather.TINY_THREADS),
                        ("kRowThreads", gather.ROW_THREADS)):
        decl = text[text.index(f"constexpr int {name} = "):].split(";")[0]
        assert int(decl.split("=")[1]) == value, name


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
