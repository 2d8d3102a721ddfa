"""The port's bounce pipeline (``parallel/pipeline.py``) on gloo ranks on
the CPU: the three cases of the JAX package's tests/test_pipeline.py. The
pipelined render is BIT-IDENTICAL to the single-process per-sample render
(pp = 4 with 4 and 8 bounces, pp = 2 with 4 bounces, beside dp on 4
ranks), does not depend on the microbatch count, and refuses a bounce
count the stages do not divide. Also held to the JAX package's
``render_pipelined`` on its virtual CPU mesh, within tests/
test_torch_render.py's tolerance (rtol = atol = 1e-4 on 99% of pixels:
XLA:CPU rounds rsqrt, sin and cos differently in the last bit)."""

import jax
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.parallel import make_mesh as jax_make_mesh
from pathtracerpython_tpu.parallel.pipeline import (
    render_pipelined as jax_pipelined,
)
from pathtracerpython_tpu.render.config import RenderConfig as JaxConfig
from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu_torch.parallel import make_mesh, render_pipelined
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import render
from pathtracerpython_tpu_torch.scene.arrays import pack_scene
from pathtracerpython_tpu_torch.scene.synthetic import cornell_box_scene
from torch_parallel_worker import PIPELINE_CASES, spawn_ranks
from torch_parity import to_jax_desc

WORLDS = (2, 4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {w: spawn_ranks("pipeline", w,
                           str(tmp_path_factory.mktemp(f"pp{w}")))
            for w in WORLDS}


@pytest.fixture(scope="module")
def scene():
    return pack_scene(cornell_box_scene(8, 8), pad_to=32, device="cpu")


CASES = [(w, pp, b) for w in WORLDS for pp, b in PIPELINE_CASES[w]]


@pytest.mark.parametrize("world,pp,bounces", CASES)
def test_pipelined_bitmatches_single_device(ranks, scene, world, pp,
                                            bounces):
    cfg = RenderConfig(mode="fast", n_samples=2, n_bounces=bounces)
    with torch.no_grad():
        single = render(scene, cfg, seed=3).numpy()
    assert np.isfinite(single).all() and single.max() > 0
    for rank in ranks[world]:
        np.testing.assert_array_equal(rank[f"pp{pp}_b{bounces}"], single)


def test_pipelined_microbatch_count_invariance(ranks):
    for rank in ranks[2]:
        np.testing.assert_array_equal(rank["microbatches4"],
                                      rank["microbatches16"])


def test_pipelined_rejects_uneven_stage_split(ranks, scene):
    assert "stages" in str(ranks[2][0]["raised:uneven"])
    # and on the degenerate mesh, where the pp axis is missing
    with pytest.raises(ValueError, match="no axis"):
        render_pipelined(scene, RenderConfig(n_bounces=2), make_mesh())


def test_pp_mesh_makes_only_the_groups_callers_use(ranks):
    """A (pp, dp, geom) mesh makes a group for each axis and for the ray
    axes (dp, geom), and refuses a line along any other set of axes."""
    for rank in ranks[2]:
        assert sorted(rank["mesh_groups"].tolist()) == [
            "dp", "dp,geom", "geom", "pp"]
        assert "not for ('pp', 'dp')" in str(rank["raised:line"])


def test_pipelined_refuses_the_soft_estimator(scene):
    cfg = RenderConfig(n_bounces=2, soft_vis_beta=0.05)
    with pytest.raises(ValueError, match="soft"):
        render_pipelined(scene, cfg, make_mesh(), pp_axis="dp")


def test_pipelined_matches_jax(ranks):
    ref = jax_arrays.pack_scene(to_jax_desc(cornell_box_scene(8, 8)),
                                pad_to=32)
    cfg = JaxConfig(mode="fast", n_samples=2, n_bounces=4,
                    backend="pallas", accel="none")
    mesh = jax_make_mesh(pp=2, dp=1, devices=jax.devices()[:2])
    want = np.asarray(jax_pipelined(ref, cfg, mesh, seed=3, pp_axis="pp"))
    got = ranks[2][0]["pp2_b4"]
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.99, (close.mean(), np.abs(got - want).max())
