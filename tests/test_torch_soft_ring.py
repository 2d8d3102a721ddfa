"""The soft estimator on the port's geometry ring
(``parallel/ring.py:soft_hits_ring``, ``soft_visibility_ring``) on gloo
ranks on the CPU, at 2 and 4 shards, against one process:

- F, h1 and h2 of seeded rays on the ring scenes of
  tests/test_torch_ring.py (a 24-box field, and the stand-in's buffer
  repeated once a shard, whose every row ties with a twin in every shard):
  the single-device dense records on every lane, rows equal, t and margin
  bit-equal, and each record's normal, material and light flag those of its
  row;
- soft renders of the occluder scene and the stand-in (beta 0.05; 1 spp, 1
  bounce and 2 spp, 2 bounces) within 1e-6 of one device: the coverage sums
  are added in the ring's order;
- the translation gradient of the moving object (the blocker, the tall
  cube) and ``tri_v0``'s on the stand-in at 1 spp, 1 bounce, within
  1e-5 relative L2 (test_torch_soft_render.py's bound against JAX);
- the JAX package's fault: its soft sweeps under ``geom_axis`` see the
  rank's own shard only, so its sharded render of tests/test_boundary.py's
  occluder scene (12x12, beta 0.03, 1 bounce, 1 spp, seed 1; dp = 1 x
  geom = 2) differs from its own render by up to 0.7315 on 48 of 144
  pixels, while the port's ring render gives JAX's single-device render
  within rtol = atol = 1e-5."""

import jax
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.parallel import make_mesh as jax_make_mesh
from pathtracerpython_tpu.parallel import render_sharded as jax_render_sharded
from pathtracerpython_tpu.render.config import RenderConfig as JaxConfig
from pathtracerpython_tpu.render.integrator import render as jax_render
from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu_torch.diff import boundary
from pathtracerpython_tpu_torch.render.integrator import render
from pathtracerpython_tpu_torch.scene.synthetic import occluder_scene
from torch_parallel_worker import (
    FAULT_KW,
    FAULT_SEED,
    SOFT_BETA,
    SOFT_PLANS,
    SOFT_SEED,
    ring_rays,
    ring_scenes,
    soft_cfg,
    soft_grad_cases,
    soft_loss_and_grad,
    soft_scenes,
    spawn_ranks,
)
from torch_parity import to_jax_desc

WORLDS = (2, 4)
RENDER_ATOL = 1e-6
LOSS_RTOL = 1e-6
GRAD_RTOL = 1e-5
JAX_RTOL = JAX_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {w: spawn_ranks("soft_ring", w,
                           str(tmp_path_factory.mktemp(f"sr{w}")),
                           timeout=240.0)
            for w in WORLDS}


@pytest.mark.parametrize("name", ["field", "tie"])
@pytest.mark.parametrize("world", WORLDS)
def test_soft_ring_records_equal_the_dense_records(ranks, world, name):
    scene = ring_scenes(world)[name]
    o, d, _ = ring_rays(scene, 300, seed=5)
    with torch.no_grad():
        want = boundary.soft_hits_sweep_dense(o, d, scene, SOFT_BETA)
    assert (want.f_idx != boundary.IMAX).sum() > 50
    assert (want.h2_idx != boundary.IMAX).sum() > 10
    for rank in ranks[world]:
        for f, v in want._asdict().items():
            np.testing.assert_array_equal(rank[f"records:{name}:{f}"],
                                          v.numpy(), err_msg=f)
        for rec in ("f", "h1", "h2"):
            idx = getattr(want, f"{rec}_idx")
            found = idx != boundary.IMAX
            rows = idx[found].long()
            key = f"records:{name}:{rec}:"
            np.testing.assert_array_equal(
                rank[key + "normal3"][:, found.numpy()],
                scene.tri_normal[rows].T.numpy())
            np.testing.assert_array_equal(
                rank[key + "material"][found.numpy()],
                scene.tri_material[rows].numpy())
            np.testing.assert_array_equal(
                rank[key + "is_light"][found.numpy()],
                scene.tri_is_light[rows].numpy())


@pytest.mark.parametrize("plan", sorted(SOFT_PLANS))
@pytest.mark.parametrize("name", ["occluder", "cornell"])
@pytest.mark.parametrize("world", WORLDS)
def test_soft_ring_render_matches_one_device(ranks, world, name, plan):
    scene, _ = soft_scenes()[name]
    with torch.no_grad():
        want = render(scene, soft_cfg(plan), seed=SOFT_SEED).numpy()
    assert want.max() > 0
    for rank in ranks[world]:
        np.testing.assert_allclose(rank[f"render:{name}:{plan}"], want,
                                   rtol=0, atol=RENDER_ATOL)


@pytest.mark.parametrize("case", sorted(soft_grad_cases()))
@pytest.mark.parametrize("world", WORLDS)
def test_soft_ring_grads_match_one_device(ranks, world, case):
    loss, grad = soft_loss_and_grad(case)
    want = grad.numpy()
    assert np.linalg.norm(want) > 0
    for rank in ranks[world]:
        got = rank[f"grad:{case}"]
        assert np.isfinite(got).all()
        np.testing.assert_allclose(float(rank[f"grad:{case}:loss"]),
                                   float(loss), rtol=LOSS_RTOL)
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err <= GRAD_RTOL, err


def test_jax_soft_ring_sees_one_shard(ranks):
    """The JAX package's sharded soft render differs from its own render
    (the JAX side stays as it is); the port's ring render is JAX's
    single-device render."""
    ref = jax_arrays.pack_scene(to_jax_desc(occluder_scene()))
    cfg = JaxConfig(mode="fast", backend="pallas", **FAULT_KW)
    single = np.asarray(jax_render(ref, cfg, seed=FAULT_SEED))
    sharded = np.asarray(jax_render_sharded(
        ref, cfg, jax_make_mesh(dp=1, geom=2, devices=jax.devices()[:2]),
        seed=FAULT_SEED, geom_axis="geom"))
    diff = np.abs(sharded - single).max(axis=1)
    assert round(float(diff.max()), 4) == 0.7315, diff.max()
    assert int((diff > 1e-3).sum()) == 48, (diff > 1e-3).sum()
    for rank in ranks[2]:
        np.testing.assert_allclose(rank["fault:ring"], single,
                                   rtol=JAX_RTOL, atol=JAX_ATOL)
