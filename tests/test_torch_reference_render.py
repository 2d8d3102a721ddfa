"""The port's reference-mode render on the CPU against the JAX package's
``render(..., mode="reference")`` (its XLA sweeps: reference mode reaches
no Pallas kernel) on the Cornell stand-in and a small box field, at 1 and
4 bounces, with ``batch_samples`` on and off; and the colour quirk of the
reference's leaked loop variable on a scene made to show it.

Tolerances: both renders run the same float32 estimator on the same random
numbers, but XLA:CPU's rsqrt, arccos, sin, cos and pow round differently
from PyTorch's in the last bit, so radiance agrees to about 1e-6; the bound
rtol = atol = 1e-4 on 99% of pixels leaves room for a rare path whose
discrete choice (a winner, an occlusion bit, the BRDF branch) flips on a
grazing ray or a coplanar tie."""

import numpy as np
import pytest
import torch

from pathtracerpython_tpu.render.config import RenderConfig as JaxConfig
from pathtracerpython_tpu.render.integrator import render as jax_render
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import render
from pathtracerpython_tpu_torch.scene import synthetic
from pathtracerpython_tpu_torch.scene.obj import mesh_from_arrays
from pathtracerpython_tpu_torch.scene.sdl import SceneDescription, SdlObject
from torch_parity import pack_pair

RTOL = ATOL = 1e-4
MIN_CLOSE = 0.99
SIZE, SPP = 12, 2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the time of a test alone and
    leaves the other test workers their cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scenes():
    return {
        "cornell": pack_pair(synthetic.cornell_box_scene(SIZE, SIZE)),
        "field": pack_pair(synthetic.box_field_scene(n_boxes=16, width=SIZE,
                                                     height=SIZE)),
    }


def _share_close(got, want):
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(axis=-1)
    return close.mean(), np.abs(got - want).max()


def _both(scene, ref, seed: int = 3, **kw):
    got = render(scene, RenderConfig(mode="reference", **kw),
                 seed=seed).numpy()
    want = np.asarray(jax_render(ref, JaxConfig(mode="reference", **kw),
                                 seed=seed))
    return got, want


@pytest.mark.parametrize("batch", [True, False])
@pytest.mark.parametrize("bounces", [1, 4])
@pytest.mark.parametrize("name", ["cornell", "field"])
def test_reference_render_matches_jax(scenes, name, bounces, batch):
    scene, ref = scenes[name]
    got, want = _both(scene, ref, n_samples=SPP, n_bounces=bounces,
                      batch_samples=batch)
    share, max_diff = _share_close(got, want)
    print(f"{name} bounces={bounces} batch={batch}: {share:.4f} of pixels "
          f"close, max abs diff {max_diff:.3g}")
    assert got.shape == (SIZE * SIZE, 3) and got.dtype == np.float32
    assert share >= MIN_CLOSE, (share, max_diff)
    # the unclamped cosine and the Phong power may go negative or NaN in
    # the reference's estimator: both packages agree on where
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isfinite(got).mean() > 0.99 and np.nanmax(got) > 0


def test_reference_plans_agree_exactly(scenes):
    scene, _ = scenes["cornell"]
    cfg = dict(mode="reference", n_samples=3, n_bounces=3)
    batched = render(scene, RenderConfig(batch_samples=True, **cfg), seed=5)
    looped = render(scene, RenderConfig(batch_samples=False, **cfg), seed=5)
    assert torch.equal(batched, looped)


def test_reference_differs_from_fast(scenes):
    """The two estimators share the RNG stream but not the estimator: a
    light hit always pays, the cosine is unclamped, the colour is the
    quirk's."""
    scene, _ = scenes["cornell"]
    ref = render(scene, RenderConfig(mode="reference", n_bounces=2),
                 seed=1)
    fast = render(scene, RenderConfig(mode="fast", n_bounces=2), seed=1)
    assert not torch.allclose(ref, fast, atol=1e-3)


def _quirk_scene(size: int) -> SceneDescription:
    """A white floor (object 0), a red blocker under the light (object 1)
    and a green quad far behind the camera (object 2, the last object: it
    neither shows nor shadows), with no ambient light. In the reference's
    estimator a floor point's direct light takes the colour of the object
    that blocked its LAST light sample, else the last object's: green or
    red, never the floor's white."""
    def quad(y, x0, x1, z0, z1, path):
        return mesh_from_arrays([[x0, y, z1], [x1, y, z1], [x1, y, z0],
                                 [x0, y, z0]], [[0, 1, 2], [0, 2, 3]],
                                path=path)

    def obj(mesh, rgb):
        return SdlObject(mesh=mesh, rgb=rgb, ka=0.0, kd=0.7, ks=0.0, kt=0.0,
                         n=1.0)

    return SceneDescription(
        eye=(0.0, 0.6, 3.0), width=size, height=size,
        ortho=(-1.0, -1.0, 1.0, 1.0), ambient=0.0,
        light_mesh=quad(1.5, -0.8, 0.8, -3.0, -1.4, "light"),
        light_color=(1.0, 1.0, 1.0),
        objects=[obj(quad(-1.0, -4, 4, -8, 2, "floor"), (1.0, 1.0, 1.0)),
                 obj(quad(0.2, -0.5, 0.5, -2.6, -1.8, "blocker"),
                     (1.0, 0.0, 0.0)),
                 obj(quad(-1.0, 40, 41, 40, 41, "far"), (0.0, 1.0, 0.0))],
    )


def test_quirk_colour_of_the_last_samples_occluder():
    scene, ref = pack_pair(_quirk_scene(16))
    got, want = _both(scene, ref, seed=7, n_samples=1, n_bounces=1,
                      n_light_samples=3)
    share, max_diff = _share_close(got, want)
    assert share >= MIN_CLOSE, (share, max_diff)
    lit = got.max(axis=-1) > 1e-6
    green = lit & (got[:, 0] == 0) & (got[:, 2] == 0)
    red = lit & (got[:, 1] == 0) & (got[:, 2] == 0)
    white = lit & (got[:, 0] > 0) & (got[:, 1] > 0)
    assert green.sum() > 20, "unblocked last samples: the last object's"
    assert red.sum() > 5, "blocked last samples: the blocker's colour"
    # the shaded object's own colour (white) shows nowhere but on the light
    light_pixels = (got == 1.0).all(axis=-1)
    assert not (white & ~light_pixels).any()
