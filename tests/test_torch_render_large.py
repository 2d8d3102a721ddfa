"""The large-scene render path on the CPU: the hybrid hierarchy (K5 nearest,
K9 any-hit), the sparse hierarchy (K5, K6; K7 with the occluder cache) and
the walker hierarchy (K8, K9), with wavefront sorting, relevance parking
and the shadow-lane sort, and the unfused NEE with the dense any-hit K4,
against the JAX package's ``render(..., backend="pallas")`` (its Pallas
kernels in interpret mode) and against the port's own dense render.

Tolerances: as tests/test_torch_render.py, radiance within rtol = atol =
1e-4 on >= 99% of pixels against JAX (XLA:CPU rounds rsqrt, sin and cos
unlike PyTorch in the last bit). Within the port the hierarchy and the
sort change no arithmetic of any lane: the hybrid equals the dense render
to atol 1e-6 (the bound of tests/test_walker.py for the JAX package), and
a sorted render equals an unsorted one exactly. The sparse, cached and
walker renders are held to 1e-6 of the hybrid's and, on the CPU, where
every sweep returns the same winners and bits, asserted equal."""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracerpython_tpu.render.config import RenderConfig as JaxConfig
from pathtracerpython_tpu.render.integrator import render as jax_render
from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu_torch.kernels import sparse
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import render
from pathtracerpython_tpu_torch.scene import arrays, synthetic
from torch_parity import to_jax_desc

RTOL = ATOL = 1e-4
MIN_CLOSE = 0.99


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: with one intra-op thread these tests take
    the same time alone and do not fight the other test workers for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pair(desc, **pack):
    """The port's and the JAX package's packing of one description;
    ``tri_order="morton"`` is the JAX package's ``morton_order=True``."""
    jax_pack = dict(pack)
    if jax_pack.pop("tri_order", None) == "morton":
        jax_pack["morton_order"] = True
    return (arrays.pack_scene(desc, **pack, device="cpu"),
            jax_arrays.pack_scene(to_jax_desc(desc), **jax_pack))


@pytest.fixture(scope="module")
def field():
    """box_field(80) at 24x24: 964 triangles in morton order."""
    return _pair(synthetic.box_field_scene(n_boxes=80, width=24, height=24),
                 tri_order="morton")


def _against_jax(pair, seed=5, **cfg):
    scene, ref = pair
    got = render(scene, RenderConfig(**cfg), seed=seed).numpy()
    want = np.asarray(jax_render(ref, JaxConfig(
        mode="fast", backend="pallas", **cfg), seed=seed))
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(axis=-1)
    print(f"{cfg}: {close.mean():.4f} of pixels close, max abs diff "
          f"{np.abs(got - want).max():.3g}")
    assert np.isfinite(got).all() and (got >= 0).all()
    assert got.std() > 0
    assert close.mean() >= MIN_CLOSE, (close.mean(), np.abs(got - want).max())
    return got


@pytest.mark.parametrize("spp,batch", [(1, False), (2, True)])
def test_hybrid_matches_jax(field, spp, batch):
    _against_jax(field, accel="hybrid", n_samples=spp, n_bounces=2,
                 batch_samples=batch)


VARIANTS = {
    "sparse": dict(accel="sparse"),
    "sparse_cached": dict(accel="sparse", nee_cache="on"),
    "walker": dict(accel="walker"),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_hierarchy_matches_jax(field, variant):
    _against_jax(field, n_samples=2, n_bounces=2, batch_samples=True,
                 **VARIANTS[variant])


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_hierarchy_equals_hybrid_render(field, variant):
    """Same winners, same occlusion bits, same permutations: the same
    radiance, whichever hierarchy sweeps."""
    scene, _ = field
    cfg = RenderConfig(accel="hybrid", n_samples=2, n_bounces=3,
                       batch_samples=True)
    hybrid = render(scene, cfg, seed=2)
    other = render(scene, dataclasses.replace(cfg, **VARIANTS[variant]),
                   seed=2)
    np.testing.assert_allclose(other.numpy(), hybrid.numpy(), rtol=0,
                               atol=1e-6)
    assert torch.equal(other, hybrid)


@pytest.mark.parametrize("knob", ["sort_nee", "nee_hint"])
def test_cache_changes_no_radiance_sorted_or_not(field, knob):
    """The cache travels with the lanes through the wavefront sort and the
    shadow-lane sort; unsorted, or with the occlusion hint leading the
    sort, the render is the same."""
    scene, _ = field
    cfg = RenderConfig(accel="sparse", nee_cache="on", n_samples=1,
                       n_bounces=3)
    flipped = dataclasses.replace(
        cfg, **{knob: "off" if knob == "sort_nee" else "on"})
    uncached = dataclasses.replace(cfg, nee_cache="off")
    want = render(scene, uncached, seed=9)
    assert torch.equal(render(scene, cfg, seed=9), want)
    assert torch.equal(render(scene, flipped, seed=9), want)


def test_cache_is_carried_and_refreshed(field, monkeypatch):
    """Bounce 1 starts cold (-1 everywhere); bounce 2's guesses are the
    clusters bounce 1 reported, carried through the sort with their
    lanes."""
    from pathtracerpython_tpu_torch.render import integrator

    scene, _ = field
    guesses = []
    real = integrator.sparse_any_hit_cached_cm

    def spy(o3, d3, maxd, sc, guess, relevant=None):
        guesses.append(guess.clone())
        return real(o3, d3, maxd, sc, guess, relevant=relevant)

    monkeypatch.setattr(integrator, "sparse_any_hit_cached_cm", spy)
    render(scene, RenderConfig(accel="sparse", nee_cache="on", n_samples=1,
                               n_bounces=2), seed=1)
    assert len(guesses) == 2
    assert (guesses[0] == -1).all()
    assert (guesses[1] >= 0).float().mean() > 0.05
    assert int(guesses[1].max()) < 8 and guesses[1].dtype == torch.int32
    # "auto" is off, and the walker hierarchy runs uncached
    guesses.clear()
    render(scene, RenderConfig(accel="sparse", n_samples=1, n_bounces=1))
    render(scene, RenderConfig(accel="walker", nee_cache="on", n_samples=1,
                               n_bounces=1))
    assert guesses == []


def test_hybrid_equals_dense_render(field):
    """The hybrid (sorted, parked, K5 + unfused NEE with K9) against the
    dense render (K1 + fused K2) of the port."""
    scene, _ = field
    cfg = RenderConfig(accel="hybrid", n_samples=2, n_bounces=3,
                       batch_samples=True)
    hybrid = render(scene, cfg, seed=2).numpy()
    dense = render(scene, dataclasses.replace(cfg, accel="none"),
                   seed=2).numpy()
    np.testing.assert_allclose(hybrid, dense, rtol=0, atol=1e-6)


@pytest.mark.parametrize("accel,knob", [
    ("hybrid", "sort_rays"), ("hybrid", "sort_nee"), ("none", "sort_rays"),
])
def test_sorted_render_equals_unsorted(field, accel, knob):
    scene, _ = field
    on = "auto" if accel == "hybrid" else "on"
    cfg = RenderConfig(accel=accel, n_samples=2, n_bounces=3,
                       **{knob: on})
    sorted_ = render(scene, cfg, seed=4)
    unsorted = render(scene, dataclasses.replace(cfg, **{knob: "off"}),
                      seed=4)
    assert torch.equal(sorted_, unsorted)


def test_nee_hint_changes_no_radiance(field):
    scene, _ = field
    cfg = RenderConfig(accel="hybrid", n_samples=1, n_bounces=3)
    assert torch.equal(render(scene, cfg, seed=6),
                       render(scene, dataclasses.replace(cfg, nee_hint="on"),
                              seed=6))


def test_auto_resolves_to_hybrid_and_matches_jax():
    """400 boxes: 4,804 triangles, past SPARSE_MIN_TRIS, so "auto" is the
    hybrid in both packages."""
    pair = _pair(synthetic.box_field_scene(n_boxes=400, width=8, height=8),
                 tri_order="morton")
    assert pair[0].num_padded_triangles >= sparse.SPARSE_MIN_TRIS
    assert sparse.resolve_accel("auto", pair[0].num_padded_triangles) == \
        "hybrid"
    _against_jax(pair, n_samples=1, n_bounces=2)


def _big_light_pair():
    """The Cornell stand-in lit by a 72-triangle light: past the fused
    NEE's 64."""
    desc = dataclasses.replace(
        synthetic.cornell_box_scene(12, 12),
        light_mesh=synthetic.grid_light(6, 6, 3.0, -0.45, 0.45, -24.3,
                                        -22.5),
    )
    return _pair(desc, pad_to=32)


def test_light_over_64_tris_matches_jax():
    pair = _big_light_pair()
    assert pair[0].light_area.shape[0] == 72
    _against_jax(pair, n_samples=2, n_bounces=2, batch_samples=True)


def test_nee_samples_over_8_matches_jax():
    desc = synthetic.cornell_box_scene(12, 12)
    _against_jax(_pair(desc, pad_to=32), n_samples=1, n_bounces=2,
                 n_light_samples=9)
