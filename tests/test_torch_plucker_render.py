"""The Plücker slice as a whole on the CPU: ``render`` under
``mt_impl="plucker"`` on the Cornell stand-in and on a small box field
through ``accel="sparse"`` and ``"hybrid"``, against the JAX package's
render with ``intersect_pallas.MT_IMPL = "plucker"`` (Pallas in interpret
mode; the knob set through ``monkeypatch``) and against the port's own
classic render; and which sweeps the knob reaches.

Tolerance: the population gate of tests/test_plucker.py. The estimator and
the random numbers are the same on both sides; only the winners and bits
of rays that graze an edge differ between the two forms, and between the
port's side products and XLA's ``dot_general``, so a few pixels move by a
whole path's contribution while the rest agree to rounding: mean abs
difference < 1e-3 and its 99.9th percentile < 0.05.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracerpython_tpu.kernels import intersect_pallas as ip
from pathtracerpython_tpu.kernels import sparse_pallas as sp
from pathtracerpython_tpu.render.config import RenderConfig as JaxConfig
from pathtracerpython_tpu.render.integrator import render as jax_render
from pathtracerpython_tpu_torch.kernels import intersect, nee, sparse, walker
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import render
from pathtracerpython_tpu_torch.scene import synthetic
from torch_parity import pack_pair

POP_MEAN = 1e-3
POP_Q999 = 0.05


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
    """The Cornell stand-in at 32x32: 3,072 radiance values, so the
    99.9th percentile tolerates one pixel that grazes an edge."""
    return pack_pair(synthetic.cornell_box_scene(32, 32), pad_to=32)


@pytest.fixture(scope="module")
def field():
    """box_field(80) at 24x24: 964 triangles in morton order."""
    return pack_pair(synthetic.box_field_scene(n_boxes=80, width=24, height=24),
                 tri_order="morton")


CELLS = {
    "cornell": ("cornell", dict(accel="auto")),
    "sparse": ("field", dict(accel="sparse")),
    "hybrid": ("field", dict(accel="hybrid")),
}
BASE = dict(n_samples=2, n_bounces=2, batch_samples=True)


def _assert_population(got, want):
    diff = np.abs(got - want)
    print(f"mean abs diff {diff.mean():.3g}, 99.9th percentile "
          f"{np.quantile(diff, 0.999):.3g}, max {diff.max():.3g}")
    assert np.isfinite(got).all() and (got >= 0).all() and got.std() > 0
    assert diff.mean() < POP_MEAN
    assert np.quantile(diff, 0.999) < POP_Q999


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_render_matches_jax_plucker(request, monkeypatch, cell):
    which, kw = CELLS[cell]
    scene, ref = request.getfixturevalue(which)
    got = render(scene, RenderConfig(mt_impl="plucker", **BASE, **kw),
                 seed=3).numpy()
    # the reference must really sweep in its Plücker form
    calls = []
    block = ip._plucker_block
    for module in (ip, sp):  # the sparse sweeps hold their own reference
        monkeypatch.setattr(module, "_plucker_block",
                            lambda *a: calls.append(1) or block(*a))
    monkeypatch.setattr(ip, "MT_IMPL", "plucker")
    want = np.asarray(jax_render(ref, JaxConfig(
        mode="fast", backend="pallas", **BASE, **kw), seed=3))
    assert calls
    _assert_population(got, want)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_render_plucker_against_classic(request, cell):
    which, kw = CELLS[cell]
    scene, _ = request.getfixturevalue(which)
    cfg = RenderConfig(**BASE, **kw)
    classic = render(scene, cfg, seed=3)
    plucker = render(scene, dataclasses.replace(cfg, mt_impl="plucker"),
                     seed=3)
    _assert_population(plucker.numpy(), classic.numpy())
    # the explicit classic value is the default's bits
    assert torch.equal(
        render(scene, dataclasses.replace(cfg, mt_impl="classic"), seed=3),
        classic)


def test_module_knob_reaches_the_render(cornell, monkeypatch):
    scene, _ = cornell
    cfg = RenderConfig(**BASE)
    plucker = render(scene, dataclasses.replace(cfg, mt_impl="plucker"),
                     seed=1)
    monkeypatch.setattr(intersect, "MT_IMPL", "plucker")
    assert torch.equal(render(scene, cfg, seed=1), plucker)
    # the config's value wins over the module's
    classic = render(scene, dataclasses.replace(cfg, mt_impl="classic"),
                     seed=1)
    monkeypatch.setattr(intersect, "MT_IMPL", "classic")
    assert torch.equal(render(scene, cfg, seed=1), classic)
    with pytest.raises(ValueError, match="mt_impl"):
        RenderConfig(mt_impl="mxu")


# Per bounce, which plain sweeps a CPU render calls under the knob: the
# Plücker forms where the JAX package has them, the classic sweeps
# elsewhere (the fused NEE K2, the cached any-hit K7, the walker's K8 and
# K9).
SITES = {
    "dense": ("cornell", dict(accel="none"),
              {"plucker nearest": 1, "K2": 1}),
    "dense-unfused": ("cornell", dict(accel="none", n_light_samples=9),
                      {"plucker nearest": 1, "plucker any-hit": 1}),
    "sparse": ("field", dict(accel="sparse"),
               {"plucker sparse nearest": 1, "plucker sparse any-hit": 1}),
    "sparse-cached": ("field", dict(accel="sparse", nee_cache="on"),
                      {"plucker sparse nearest": 1, "K7": 2}),
    "hybrid": ("field", dict(accel="hybrid"),
               {"plucker sparse nearest": 1, "K9": 1}),
    "walker": ("field", dict(accel="walker"), {"K8": 1, "K9": 1}),
}


@pytest.mark.parametrize("site", sorted(SITES))
def test_launch_sites_under_the_knob(request, monkeypatch, site):
    which, kw, per_bounce = SITES[site]
    scene, _ = request.getfixturevalue(which)
    counts = {}

    def count(module, name, key, only=lambda *a, **k: True):
        fn = getattr(module, name)

        def counted(*a, **k):
            if only(*a, **k):
                counts[key] = counts.get(key, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, counted)

    classic_call = lambda *a, **k: len(a) < 4 and "pair" not in k
    count(intersect, "nearest_t_idx_plucker_plain", "plucker nearest")
    count(intersect, "any_hit_plucker_plain", "plucker any-hit")
    count(sparse, "sparse_nearest_plucker_plain", "plucker sparse nearest")
    count(sparse, "sparse_any_hit_plucker_plain", "plucker sparse any-hit")
    # the classic sweeps, counted where a wrapper calls them (the Plücker
    # plain versions reuse their merges with another pair test)
    count(intersect, "nearest_t_idx_plain", "K1", classic_call)
    count(intersect, "any_hit_plain", "K4",
          lambda *a, **k: len(a) < 5 and "pair" not in k)
    count(nee, "nee_mean_cos_plain", "K2")
    count(sparse, "sparse_nearest_plain", "K5",
          lambda *a, **k: len(a) < 8 and "pair" not in k)
    count(sparse, "sparse_any_hit_plain", "K6",
          lambda *a, **k: len(a) < 9 and "pair" not in k)
    count(sparse, "sparse_any_hit_idx_plain", "K7")
    count(walker, "walker_nearest_plain", "K8")
    count(walker, "walker_any_hit_plain", "K9")

    bounces = 2
    cfg = RenderConfig(mt_impl="plucker", n_samples=1, n_bounces=bounces,
                       **kw)
    rad = render(scene, cfg, seed=0)
    assert torch.isfinite(rad).all()
    assert counts == {k: v * bounces for k, v in per_bounce.items()}
