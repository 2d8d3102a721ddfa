"""The two-pass protocol of the uncached cluster sweeps (``two_pass=`` of
``kernels/sparse.py``'s K5 and K6 entries) against the JAX package's
two-pass sweeps, their Pallas kernels in interpret mode as
tests/test_sparse.py runs them, on that file's case; and what the JAX
package's pass 1 does under ``MT_IMPL = "plucker"``. The rest of the
protocol is held in tests/test_torch_two_pass.py.

Tolerances: winners equal except on grazing pairs (float64 barycentric
margin < 1e-5) and t within 1e-6, the bounds of tests/torch_parity.py;
occlusion bits equal; the port's Plücker sweeps equal to themselves bit
for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.kernels import intersect_pallas as ip
from pathtracerpython_tpu.kernels import sparse_pallas as sp
from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu_torch.kernels import sparse
from pathtracerpython_tpu_torch.scene import arrays, synthetic
from torch_parity import (
    GRAZING_MARGIN,
    T_ATOL,
    T_RTOL,
    bary_margin_f64,
    field_rays,
    to_jax_desc,
)

SMALL, BIG_BRANCH = 1, 10**6   # m_div: pass 2 always fits / never fits


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: with one intra-op thread these tests take
    the same time alone and do not fight the other test workers for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def jax_case():
    """tests/test_sparse.py::test_two_pass_bitmatch's case: 700 random rays
    (seed 21) in box_field(80), maxd 8; the JAX package's two-pass sweeps
    at two_pass=4, and under MT_IMPL = "plucker" its two-pass nearest sweep
    with pass 2 compacted (m_div=1: at M_DIV this case takes the whole
    wavefront again, which hides what pass 1 did) and its one-pass one."""
    desc = synthetic.box_field_scene(n_boxes=80, width=24, height=24)
    scene = arrays.pack_scene(desc, tri_order="morton", device="cpu")
    ref = jax_arrays.pack_scene(to_jax_desc(desc), morton_order=True)
    o3, d3u = field_rays(700, seed=21)
    jo, jd = jnp.asarray(o3.numpy()), jnp.asarray(d3u.numpy())
    maxd = torch.full((700,), 8.0)
    out = {"nearest": sp.sparse_nearest_t_idx_cm(jo, jd, ref, two_pass=4),
           "any": sp.sparse_any_hit_cm(jo, jd, jnp.asarray(maxd.numpy()),
                                       ref, two_pass=4)}
    before = ip.MT_IMPL
    ip.MT_IMPL = "plucker"
    try:
        out["plucker two"] = sp.sparse_nearest_t_idx_cm(
            jo, jd, ref, two_pass=4, m_div=SMALL)
        out["plucker one"] = sp.sparse_nearest_t_idx_cm(jo, jd, ref,
                                                        two_pass=0)
    finally:
        ip.MT_IMPL = before
    out = {k: tuple(np.asarray(x) for x in v) if isinstance(v, tuple)
           else np.asarray(v) for k, v in out.items()}
    return scene, o3, d3u, maxd, out


def test_two_pass_matches_jax(jax_case):
    scene, o3, d3u, maxd, out = jax_case
    t, idx = sparse.sparse_nearest_t_idx_cm(o3, d3u, scene, two_pass=4)
    t, idx = t.numpy(), idx.numpy()
    jt, jidx = out["nearest"]
    same = idx == jidx
    tri = [scene.tri_v0.numpy(), scene.tri_v1.numpy(), scene.tri_v2.numpy()]
    for r in np.nonzero(~same)[0]:
        margins = [abs(bary_margin_f64(tri[0][i], tri[1][i], tri[2][i],
                                       o3[:, r].numpy(), d3u[:, r].numpy()))
                   for i in (idx[r], jidx[r]) if i >= 0]
        assert margins and min(margins) < GRAZING_MARGIN, (r, margins)
    assert same.mean() > 0.99 and (idx >= 0).mean() > 0.3
    np.testing.assert_allclose(t[same], jt[same], rtol=T_RTOL, atol=T_ATOL)
    occ = sparse.sparse_any_hit_cm(o3, d3u, maxd, scene, two_pass=4)
    np.testing.assert_array_equal(occ.numpy(), out["any"])


def test_plucker_knob_jax_mixes_the_forms(jax_case):
    """Under MT_IMPL = "plucker" the JAX package's pass 1 takes the classic
    ungrouped kernel (sparse_pallas.py:1652-1654) and its pass 2 the
    Plücker one, so its two-pass result mixes the forms: lanes that pass 1
    finished carry the classic t (2 of the 700 here, of the 90 whose t
    the forms round differently). The port runs both passes in the knob's
    form: its two-pass Plücker sweep is its one-pass Plücker sweep bit for
    bit, in both branches."""
    scene, o3, d3u, _, out = jax_case
    two_t, two_i = out["plucker two"]
    one_t, one_i = out["plucker one"]
    classic_t, classic_i = out["nearest"]
    mixed = (two_t != one_t) | (two_i != one_i)
    print(f"JAX two-pass Plücker differs from its one-pass Plücker on "
          f"{int(mixed.sum())} of {mixed.size} lanes")
    assert mixed.any()
    assert ((two_t == classic_t) & (two_i == classic_i))[mixed].all()
    want = sparse.sparse_nearest_t_idx_cm(o3, d3u, scene, two_pass=0,
                                          mt_impl="plucker")
    for m_div in (SMALL, BIG_BRANCH):
        got = sparse.sparse_nearest_t_idx_cm(o3, d3u, scene, two_pass=4,
                                             m_div=m_div, mt_impl="plucker")
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    occ = sparse.sparse_any_hit_cm(o3, d3u, torch.full((700,), 8.0), scene,
                                   two_pass=4, mt_impl="plucker")
    assert torch.equal(occ, sparse.sparse_any_hit_cm(
        o3, d3u, torch.full((700,), 8.0), scene, two_pass=0,
        mt_impl="plucker"))
