"""Gradients through the cluster hierarchies on the CPU.

- The port's counterparts of tests/test_sparse.py::test_gradients_bitmatch
  and tests/test_walker.py::test_walker_gradients_flow: the gradients of
  the summed hit distance with respect to the rays and the vertices through
  ``accel="sparse"`` (K5, blocks of 512 and the hybrid's 1024), ``"walker"``
  (K8) and K3's sparse nearest are the dense sweep's (K1, K3's dense
  nearest) bit for bit: each walk sees detached inputs and shares the dense
  sweep's one re-solve (``intersect.nearest_bwd``), so no gradient is lost
  on the way through a list or a cache.
- The loss and gradients of every scene and camera field through
  ``pixel_loss`` and ``camera_pixel_loss`` with ``accel="sparse"`` and
  ``"walker"`` forced on a small box field, against the JAX package
  (``backend="pallas"``, interpret mode). Tolerances: torch_diff_parity.py's
  (loss 1e-6 relative, gradients 1e-4 relative L2 per field).
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracerpython_tpu_torch.kernels import intersect, sparse, walker
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.ops.geometry import normalize3
from pathtracerpython_tpu_torch.scene import arrays, synthetic
from torch_diff_parity import run_case
from torch_parity import pack_pair

BASE = dict(n_samples=1, n_bounces=2, n_light_samples=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: with one intra-op thread these tests take
    the same time alone and do not fight the other test workers for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def field():
    """tests/test_sparse.py's field: 80 boxes (964 triangles, 8 clusters),
    morton order."""
    return arrays.pack_scene(synthetic.box_field_scene(n_boxes=80, width=24,
                                                       height=24),
                             tri_order="morton", device="cpu")


def _primary(scene):
    o, d = make_primary_rays(scene.eye, scene.ortho, scene.meta.width,
                             scene.meta.height)
    return o.T.contiguous(), normalize3(d.T).contiguous()


def _random(n, seed):
    """tests/test_walker.py's incoherent rays inside the field."""
    rs = np.random.default_rng(seed)
    o = rs.uniform([-8, -1, -16], [8, 1.5, 3], (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    return (torch.from_numpy(o.T.copy()),
            normalize3(torch.from_numpy(d.T.copy())).contiguous())


SWEEPS = {
    "none": lambda o, d, sc: intersect.nearest_t_idx_cm(o, d, sc),
    "sparse": lambda o, d, sc: sparse.sparse_nearest_t_idx_cm(o, d, sc),
    "hybrid": lambda o, d, sc: sparse.sparse_nearest_t_idx_cm(
        o, d, sc, r_blk=sparse.R_BLK_HYBRID_NEAREST),
    "walker": lambda o, d, sc: walker.walker_nearest_t_idx_cm(o, d, sc),
    "plucker": lambda o, d, sc: intersect.nearest_t_idx_cm(
        o, d, sc, mt_impl="plucker"),
    "sparse plucker": lambda o, d, sc: sparse.sparse_nearest_t_idx_cm(
        o, d, sc, mt_impl="plucker"),
}


def _grads(scene, sweep, rays):
    """(t, idx, grads of sum(t) wrt o3, d3 and the three vertex buffers)."""
    leaves = [x.clone().requires_grad_(True) for x in (
        *rays, scene.tri_v0, scene.tri_v1, scene.tri_v2)]
    sc = dataclasses.replace(scene, tri_v0=leaves[2], tri_v1=leaves[3],
                             tri_v2=leaves[4])
    t, idx = sweep(leaves[0], leaves[1], sc)
    t.sum().backward()
    return t.detach(), idx, [x.grad for x in leaves]


@pytest.mark.parametrize("rays", ["primary", "random"])
@pytest.mark.parametrize("accel,dense", [
    ("sparse", "none"), ("hybrid", "none"), ("walker", "none"),
    ("sparse plucker", "plucker"),
])
def test_hierarchy_grads_bitmatch_dense(field, accel, dense, rays):
    r = _primary(field) if rays == "primary" else _random(1024, seed=5)
    t, idx, got = _grads(field, SWEEPS[accel], r)
    want_t, want_idx, want = _grads(field, SWEEPS[dense], r)
    assert torch.equal(idx, want_idx) and torch.equal(t, want_t)
    assert (idx >= 0).float().mean() > 0.3
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.equal(g, w)
    assert got[2].abs().sum() > 0  # the vertices do get a gradient


@pytest.fixture(scope="module")
def small_field():
    return pack_pair(synthetic.box_field_scene(n_boxes=40, width=8,
                                               height=8))


@pytest.mark.parametrize("loss", ["camera", "pixel"])
@pytest.mark.parametrize("accel", ["sparse", "walker"])
def test_hierarchy_loss_and_grads_match_jax(small_field, accel, loss):
    worst = run_case(*small_field, {**BASE, "accel": accel},
                     loss == "camera")
    print(f"{accel} {loss}: worst relative L2 {worst:.3g}")
