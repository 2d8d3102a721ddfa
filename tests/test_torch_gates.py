"""The port's dispatch gates against the JAX package's, on a grid of
configurations: mode x soft visibility x geometry ring x accel x the sort
knobs, on a dense scene and on one past ``SPARSE_MIN_TRIS``.

- ``_sort_enabled`` (wavefront sorting) and ``_nee_sort_enabled``
  (shadow-lane sorting and relevance parking) against the JAX functions of
  the same names, called directly (plain Python);
- ``_fused_nee`` (K2) against the condition inline in the JAX package's
  ``shade_nee`` (``render/integrator.py:215-220``), written out below from
  its constants. The port's gate also requires ``n_light_samples <=
  MAX_LIGHT_SAMPLES`` (the kernel holds the samples in registers; JAX's
  kernel takes any count): the grid draws 3 samples, and one case holds
  that 9 take the unfused NEE.

JAX configurations are built with ``backend="pallas"``: its gates are off
on the XLA backend, which the port does not have. Reference mode renders
and must never be sorted, nor take the fused NEE; the geometry ring, soft
estimator included, renders through the ring's sweeps, and the gates must
say no for it all the same."""

import itertools

import pytest
import torch

from pathtracerpython_tpu.kernels.nee_pallas import FUSED_NEE_MAX_LIGHT_TRIS
from pathtracerpython_tpu.kernels.sparse_pallas import (
    resolve_accel as jax_resolve_accel,
)
from pathtracerpython_tpu.render import integrator as jax_integrator
from pathtracerpython_tpu.render.config import RenderConfig as JaxConfig
from pathtracerpython_tpu_torch.render import integrator
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.scene import synthetic
from torch_parity import pack_pair

GRID = dict(
    mode=("fast", "reference"),
    soft_vis_beta=(0.0, 0.05),
    geom_axis=(None, "geom"),
    accel=("auto", "none", "sparse", "walker", "hybrid"),
    sort_rays=("auto", "on", "off"),
    sort_nee=("auto", "on", "off"),
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: with one intra-op thread these tests take
    the same time alone and do not fight the other test workers for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scenes():
    """(port, JAX) packs: the Cornell stand-in (128 padded rows, dense) and
    a 400-box field (4,864 padded rows, past SPARSE_MIN_TRIS)."""
    return {
        "dense": pack_pair(synthetic.cornell_box_scene(4, 4)),
        "large": pack_pair(synthetic.box_field_scene(n_boxes=400, width=4,
                                                     height=4)),
    }


def configs():
    """(port config, JAX config) over the grid; soft visibility is a
    fast-mode feature in both packages."""
    for values in itertools.product(*GRID.values()):
        kw = dict(zip(GRID, values))
        if kw["soft_vis_beta"] > 0 and kw["mode"] == "reference":
            continue
        kw["geom_axis_size"] = 0 if kw["geom_axis"] is None else 2
        yield RenderConfig(**kw), JaxConfig(backend="pallas", **kw)


def jax_fused_nee(scene, cfg) -> bool:
    """The fused-NEE condition of the JAX package's ``shade_nee``."""
    return (cfg.mode == "fast" and cfg.backend == "pallas"
            and cfg.geom_axis is None
            and scene.light_v0.shape[0] <= FUSED_NEE_MAX_LIGHT_TRIS
            and cfg.soft_vis_beta == 0.0
            and jax_resolve_accel(cfg.accel,
                                  scene.num_padded_triangles) == "none")


GATES = {
    "sort_rays": (integrator._sort_enabled, jax_integrator._sort_enabled),
    "sort_nee": (integrator._nee_sort_enabled,
                 jax_integrator._nee_sort_enabled),
    "fused_nee": (integrator._fused_nee, jax_fused_nee),
}


@pytest.mark.parametrize("which", ["dense", "large"])
@pytest.mark.parametrize("gate", sorted(GATES))
def test_gate_gives_jax_answer(scenes, which, gate):
    port_gate, jax_gate = GATES[gate]
    scene, jax_scene = scenes[which]
    wrong, seen = [], set()
    n = 0
    for cfg, jax_cfg in configs():
        got, want = port_gate(scene, cfg), jax_gate(jax_scene, jax_cfg)
        seen.add(want)
        n += 1
        if got != want:
            wrong.append((cfg, got, want))
    assert n == 270
    assert not wrong, wrong[:5]
    # the grid reaches both answers wherever JAX's gate has both
    assert seen == {True, False}


def test_fused_nee_needs_its_sample_count(scenes):
    """The port's one condition beyond JAX's: more light samples than the
    kernel holds take the unfused NEE."""
    scene, _ = scenes["dense"]
    assert integrator._fused_nee(scene, RenderConfig(n_light_samples=3))
    assert not integrator._fused_nee(scene, RenderConfig(n_light_samples=9))
