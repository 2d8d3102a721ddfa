"""K3, the Plücker form of the sweeps that follow the ``MT_IMPL`` knob, and
the two probes P1 and P2: the port's plain versions against the JAX
package's Pallas kernels under ``intersect_pallas.MT_IMPL = "plucker"``
(interpret mode on the CPU, the knob set through ``monkeypatch``), against
the port's classic form, and the sparse sweeps against the dense one. The
counterpart of tests/test_plucker.py on in-repo scenes.

Tolerances, with their reasons:

- packs: edge directions, normals, vertices and flags of the port's
  ``plucker_packs`` equal ``_plucker_packs`` bit for bit; an edge moment
  a x b is a difference of two rounded products, and XLA:CPU fuses one of
  them into the subtraction, so a moment component agrees to 1 ulp of the
  largest of its two products and itself (not of the difference alone,
  which cancels);
- dense nearest against the JAX Plücker kernel: XLA's ``dot_general`` sums
  the six products of a side in its own order, so a side within an ulp of
  zero can change sign: winners equal but for at most max(8, 0.2%) of
  lanes, each such lane within 1e-4 of a triangle edge in float64, t
  within rtol 1e-5 on the other lanes; any-hit bits differ on < 0.2%;
- Plücker against classic within the port: the contract of
  tests/test_plucker.py (the same gates, t within 2e-4);
- sparse Plücker against dense Plücker: the same arithmetic on the same
  rows, so bit-equal, t error 0.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.kernels import intersect_pallas as ip
from pathtracerpython_tpu_torch.kernels import intersect, sparse
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.ops.geometry import normalize3
from pathtracerpython_tpu_torch.probes import bf16_probe, mma_probe
from pathtracerpython_tpu_torch.scene import synthetic
from torch_parity import bary_margin_f64, pack_pair

MAX_FRAC = 2e-3        # share of lanes whose winner or bit may differ
FORM_MARGIN = 1e-4     # float64 barycentric margin of such a lane
T_RTOL_JAX = 1e-5      # t against the JAX Plücker kernel, equal winners
T_TOL_CLASSIC = 2e-4   # t against the classic form, equal winners


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: with one intra-op thread these tests take
    the same time alone and do not fight the other test workers for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cornell():
    return pack_pair(synthetic.cornell_box_scene(24, 24), pad_to=32)


@pytest.fixture(scope="module")
def field():
    """box_field(80) in morton order: 964 triangles, more than the JAX
    kernel's 512-row block, so its block-culled variant runs."""
    return pack_pair(synthetic.box_field_scene(n_boxes=80, width=24, height=24),
                 tri_order="morton")


@pytest.fixture()
def jax_plucker(monkeypatch):
    monkeypatch.setattr(ip, "MT_IMPL", "plucker")


def _rays(scene, n=None, seed=0):
    """Primary rays of the scene's camera, or ``n`` incoherent rays drawn
    with numpy as tests/test_plucker.py draws them; (o3, d3 unit) numpy."""
    if n is None:
        o, d = make_primary_rays(scene.eye, scene.ortho, scene.meta.width,
                                 scene.meta.height)
        o3, d3 = o.T.contiguous(), d.T.contiguous()
    else:
        rs = np.random.default_rng(seed)
        o = rs.uniform([-8, -1, -16], [8, 1.5, 3], (n, 3)).astype(np.float32)
        d = rs.normal(size=(n, 3)).astype(np.float32)
        o3 = torch.from_numpy(np.ascontiguousarray(o.T))
        d3 = torch.from_numpy(np.ascontiguousarray(d.T))
    return o3.numpy(), normalize3(d3).contiguous().numpy()


CASES = {
    "cornell-primary": ("cornell", None, 0),
    "field-primary": ("field", None, 0),
    "field-incoherent": ("field", 700, 11),
}


def _case(request, name):
    which, n, seed = CASES[name]
    scene, ref = request.getfixturevalue(which)
    return scene, ref, *_rays(scene, n, seed)


def _assert_winners_agree(scene, o3, d3, got, want, t_rtol, t_atol):
    (t_g, i_g), (t_w, i_w) = got, want
    agree = i_g == i_w
    np.testing.assert_allclose(t_g[agree], t_w[agree], rtol=t_rtol,
                               atol=t_atol)
    bad = np.nonzero(~agree)[0]
    assert len(bad) <= max(8, MAX_FRAC * len(i_g)), len(bad)
    tri = [scene.tri_v0.numpy(), scene.tri_v1.numpy(), scene.tri_v2.numpy()]
    for r in bad:
        margins = [abs(bary_margin_f64(tri[0][i], tri[1][i], tri[2][i],
                                       o3[:, r], d3[:, r]))
                   for i in (i_g[r], i_w[r]) if i >= 0]
        assert margins and min(margins) < FORM_MARGIN, (r, margins)
    return len(bad)


def _port_nearest(scene, o3, d3, **kw):
    t, idx = intersect.nearest_t_idx_cm(torch.from_numpy(o3),
                                        torch.from_numpy(d3), scene, **kw)
    return t.numpy(), idx.numpy()


@pytest.mark.parametrize("which", ["cornell", "field"])
def test_plucker_packs_match_jax(request, which):
    scene, ref = request.getfixturevalue(which)
    epacks, nv = intersect.plucker_packs(intersect.scene_tripack(scene))
    jpack = ip.pack_triangles(ref.tri_v0, ref.tri_v1, ref.tri_v2,
                              ref.tri_valid, ref.tri_occluder)
    jepacks, jnv = ip._plucker_packs(jpack)
    assert [tuple(e.shape) for e in epacks] == [(jpack.shape[0], 8)] * 3
    assert tuple(nv.shape) == (jpack.shape[0], 12)
    np.testing.assert_array_equal(nv.numpy(), np.asarray(jnv))
    tp = intersect.scene_tripack(scene).numpy()
    verts = [tp[:, 0:3], tp[:, 3:6], tp[:, 6:9]]
    for k, (got, want) in enumerate(zip(epacks, jepacks)):
        got, want = got.numpy(), np.asarray(want)
        np.testing.assert_array_equal(got[:, 0:3], want[:, 0:3])
        np.testing.assert_array_equal(got[:, 6:8], want[:, 6:8])
        a, b = verts[k], verts[(k + 1) % 3]
        # component c of a x b is a[c+1] b[c+2] - a[c+2] b[c+1]
        larger = np.stack([
            np.maximum(np.abs(a[:, (c + 1) % 3] * b[:, (c + 2) % 3]),
                       np.abs(a[:, (c + 2) % 3] * b[:, (c + 1) % 3]))
            for c in range(3)], axis=1)
        scale = np.maximum(larger, np.abs(want[:, 3:6])).astype(np.float32)
        assert (np.abs(got[:, 3:6] - want[:, 3:6])
                <= np.spacing(scale)).all()
    # the one pack the kernels read is the four side by side
    pack36 = intersect.plucker_pack(intersect.scene_tripack(scene))
    assert torch.equal(pack36, torch.cat([*epacks, nv], dim=1))
    assert pack36.is_contiguous() and pack36.shape[1] == intersect.PLUCKER_COLS


@pytest.mark.parametrize("name", sorted(CASES))
def test_dense_nearest_matches_jax_plucker(request, jax_plucker, name):
    scene, ref, o3, d3 = _case(request, name)
    got = _port_nearest(scene, o3, d3, mt_impl="plucker")
    want = tuple(map(np.asarray, ip.nearest_t_idx_cm(
        jnp.asarray(o3), jnp.asarray(d3), ref)))
    assert (got[1] >= 0).mean() > 0.25
    _assert_winners_agree(scene, o3, d3, got, want, T_RTOL_JAX, 1e-6)


def test_jax_knob_changes_the_jax_sweep(field, monkeypatch):
    """The reference side of these tests really runs its Plücker kernel:
    under the knob its t differs from the classic kernel's in the last
    bits, as the two forms' rounding does."""
    scene, ref = field
    o3, d3 = _rays(scene, 700, 11)
    run = lambda: np.asarray(ip.nearest_t_idx_cm(
        jnp.asarray(o3), jnp.asarray(d3), ref)[0])
    classic = run()
    monkeypatch.setattr(ip, "MT_IMPL", "plucker")
    assert not np.array_equal(run(), classic)


def test_dense_any_hit_matches_jax_plucker(field, jax_plucker):
    scene, ref = field
    o3, d3 = _rays(scene, 1024, 5)
    maxd = np.full(o3.shape[1], 50.0, np.float32)
    got = intersect.any_hit_cm(*map(torch.from_numpy, (o3, d3, maxd)), scene,
                               mt_impl="plucker").numpy()
    want = np.asarray(ip.any_hit_pallas_cm(
        jnp.asarray(o3), jnp.asarray(d3), jnp.asarray(maxd), ref))
    assert got.any() and not got.all()
    assert (got != want).mean() < MAX_FRAC


@pytest.mark.parametrize("name", sorted(CASES))
def test_plucker_nearest_agrees_with_classic(request, name):
    scene, _, o3, d3 = _case(request, name)
    classic = _port_nearest(scene, o3, d3)
    plucker = _port_nearest(scene, o3, d3, mt_impl="plucker")
    _assert_winners_agree(scene, o3, d3, plucker, classic, T_TOL_CLASSIC,
                          T_TOL_CLASSIC)
    # another form, not the same arithmetic under another name
    assert not np.array_equal(plucker[0], classic[0])


def test_plucker_any_hit_agrees_with_classic(field):
    scene, _ = field
    o3, d3 = _rays(scene, 1024, 5)
    args = [*map(torch.from_numpy, (o3, d3)), torch.full((1024,), 50.0)]
    classic = intersect.any_hit_cm(*args, scene)
    plucker = intersect.any_hit_cm(*args, scene, mt_impl="plucker")
    assert (classic != plucker).float().mean().item() < MAX_FRAC
    assert plucker.any()


@pytest.mark.parametrize("r_blk", [512, 1024])
def test_sparse_plucker_nearest_equals_dense_plucker(field, r_blk):
    scene, _ = field
    o3, d3 = map(torch.from_numpy, _rays(scene, 1500, 7))
    t_d, i_d = intersect.nearest_t_idx_cm(o3, d3, scene, mt_impl="plucker")
    t_s, i_s = sparse.sparse_nearest_t_idx_cm(o3, d3, scene, r_blk=r_blk,
                                              mt_impl="plucker")
    assert (i_d >= 0).any()
    assert torch.equal(i_s, i_d)
    assert torch.equal(t_s, t_d)


def test_sparse_plucker_any_hit_equals_dense_plucker(field):
    scene, _ = field
    o3, d3 = map(torch.from_numpy, _rays(scene, 1024, 5))
    maxd = torch.full((1024,), 6.0)
    occ_d = intersect.any_hit_cm(o3, d3, maxd, scene, mt_impl="plucker")
    occ_s = sparse.sparse_any_hit_cm(o3, d3, maxd, scene, mt_impl="plucker")
    assert torch.equal(occ_s, occ_d)
    assert occ_d.any()


def test_knob_and_keyword(field, monkeypatch):
    """The module knob is read at every call, the keyword overrides it, and
    the default is the classic form with the bits it always gave."""
    scene, _ = field
    o3, d3 = map(torch.from_numpy, _rays(scene, 300, 3))
    maxd = torch.full((300,), 6.0)
    assert intersect.MT_IMPL == "classic"
    classic = intersect.nearest_t_idx_cm(o3, d3, scene)
    tripack = intersect.scene_tripack(scene)
    for got, want in zip(classic,
                         intersect.nearest_t_idx_plain(o3, d3, tripack)):
        assert torch.equal(got, want)
    plucker = intersect.nearest_t_idx_cm(o3, d3, scene, mt_impl="plucker")
    sparse_classic = sparse.sparse_nearest_t_idx_cm(o3, d3, scene)
    occ_plucker = sparse.sparse_any_hit_cm(o3, d3, maxd, scene,
                                           mt_impl="plucker")
    monkeypatch.setattr(intersect, "MT_IMPL", "plucker")
    for got, want in zip(intersect.nearest_t_idx_cm(o3, d3, scene), plucker):
        assert torch.equal(got, want)
    for got, want in zip(sparse.sparse_nearest_t_idx_cm(o3, d3, scene),
                         plucker):
        assert torch.equal(got, want)
    assert torch.equal(sparse.sparse_any_hit_cm(o3, d3, maxd, scene),
                       occ_plucker)
    for got, want in zip(
            sparse.sparse_nearest_t_idx_cm(o3, d3, scene, mt_impl="classic"),
            sparse_classic):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="mt_impl"):
        intersect.nearest_t_idx_cm(o3, d3, scene, mt_impl="mxu")
    monkeypatch.setattr(intersect, "MT_IMPL", "tf32")
    with pytest.raises(ValueError, match="mt_impl"):
        intersect.any_hit_cm(o3, d3, maxd, scene)


def test_scene_packs_are_derived_once_per_scene(field, cornell):
    scene, _ = field
    first = intersect.scene_plucker_pack(scene)
    assert intersect.scene_plucker_pack(scene) is first
    padded = intersect.scene_plucker_pack(scene, sparse.PACK_ROWS)
    assert padded.shape[0] % sparse.PACK_ROWS == 0
    assert torch.equal(padded[:first.shape[0]], first)
    assert not padded[first.shape[0]:].any()
    assert intersect.scene_plucker_pack(scene) is first
    # another scene, or a changed vertex, derives anew
    other = intersect.scene_plucker_pack(cornell[0])
    assert other.shape[0] == cornell[0].num_padded_triangles
    again = intersect.scene_plucker_pack(scene)
    assert again is not first and torch.equal(again, first)
    scene.tri_v0[0, 0] += 1.0
    try:
        moved = intersect.scene_plucker_pack(scene)
        assert moved is not again and not torch.equal(moved, again)
    finally:
        scene.tri_v0[0, 0] -= 1.0


def test_pad_and_degenerate_rows_never_hit():
    """All-zero sides make ``inside`` true for a pad or degenerate row: the
    parallel test and the valid column must reject it."""
    tripack = torch.zeros((3, 12))
    tripack[1, 0:9] = torch.tensor([0., 0, 5, 1, 0, 5, 2, 0, 5])  # collinear
    tripack[1, 9:11] = 1.0
    tripack[2, 0:9] = torch.tensor([-1., -1, 5, 1, -1, 5, 0, 1, 5])
    tripack[2, 9:11] = 1.0
    pack36 = intersect.plucker_pack(tripack)
    o3 = torch.zeros((3, 2))
    d3 = torch.tensor([[0., 0.3], [0., 0.0], [1., 0.954]])
    d3 = normalize3(d3).contiguous()
    t, idx = intersect.nearest_t_idx_plucker_plain(o3, d3, pack36)
    assert idx.tolist() == [2, -1]
    assert t[0].item() == pytest.approx(5.0)


def test_mma_probe_plain_variants():
    """P1 on the CPU at 4,096 rays x 128 triangles: the Plücker form meets
    the probe's own gate against the classic form, the 3xTF32 emulation
    too; one pass of TF32 is allowed to miss it (that is the finding)."""
    o3, d3, tripack = mma_probe.make_inputs(4096, 128, 0)
    results = {v: mma_probe.probe(o3, d3, tripack, v)
               for v in mma_probe.VARIANTS}
    t_mt, i_mt = results["mt"]
    assert ((i_mt == mma_probe.IMAX) == (t_mt == mma_probe.BIG)).all()
    assert 0.05 < (i_mt != mma_probe.IMAX).float().mean() < 0.95
    for variant in mma_probe.ASSERTED:
        diff = mma_probe.compare(tripack, o3, d3, results[variant],
                                 results["mt"])
        assert diff["winner_diff_share"] < mma_probe.MAX_WINNER_DIFF, diff
        assert diff["max_t_err"] < mma_probe.MAX_T_ERR, diff
    one_pass = mma_probe.compare(tripack, o3, d3, results["plucker_tf32"],
                                 results["mt"])
    split = mma_probe.compare(tripack, o3, d3, results["plucker_3xtf32"],
                              results["mt"])
    assert one_pass["winner_diff_rays"] >= split["winner_diff_rays"]
    # the emulated rounding keeps 10 mantissa bits
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -3.1415927])
    assert mma_probe.tf32(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                                          -3.140625]


def test_bf16_probe_plain_variants():
    """P2 on the CPU: the float32 count is ``mt_rows``' hit count, and the
    bf16 count differs from it by what the probe itself reports."""
    o3, d3, tripack = bf16_probe.make_inputs(4096, 128, 0)
    f32 = bf16_probe.hit_count(o3, d3, tripack, "f32")
    hit, _ = intersect.mt_rows(tripack, *(o3[k:k + 1] for k in range(3)),
                               *(d3[k:k + 1] for k in range(3)))
    assert torch.equal(f32, hit.sum(dim=0, dtype=torch.float32))
    assert f32.sum() > 0
    bf16 = bf16_probe.hit_count(o3, d3, tripack, "bf16")
    rows = bf16_probe.run(4096, 128, reps=1, device="cpu")
    verdict = rows[-1]
    diff = (bf16 - f32).abs()
    assert verdict["max_count_diff"] == diff.max().item()
    assert verdict["rays_with_other_count"] == pytest.approx(
        (diff > 0).float().mean().item())
    # bf16 keeps 8 mantissa bits: some counts move, the population does not
    assert 0 < verdict["rays_with_other_count"] < 0.5
    assert abs(bf16.mean() - f32.mean()) < 0.05 * f32.mean()


def test_probes_run_as_modules_on_the_cpu_and_refuse_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "pathtracerpython_tpu_torch.probes.mma_probe",
         "--device", "cpu", "--rays", "4096", "--tris", "128", "--reps", "1"],
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == len(mma_probe.VARIANTS) + 1
    assert '"plucker_3xtf32_vs_mt"' in lines[-1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mma_probe.run(256, 16, reps=1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bf16_probe.run(256, 16, reps=1)
