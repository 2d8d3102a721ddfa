"""The port's fast-mode render on the CPU against the JAX package's
``render(..., backend="pallas", accel="none")`` (its Pallas kernels in
interpret mode) on the Cornell stand-in, and the options the first slice
refused and the port now renders.

Tolerances: both renders run the same float32 estimator on the same random
numbers, but XLA:CPU's rsqrt, sin and cos round differently from
PyTorch's in the last bit, so radiance agrees to about 1e-6. The bound
rtol = atol = 1e-4 on 99% of pixels leaves room for a rare path whose
discrete choice (a winner or an occlusion bit) flips on a grazing ray."""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracerpython_tpu.render.config import RenderConfig as JaxConfig
from pathtracerpython_tpu.render.image import radiance_to_image as jax_to_image
from pathtracerpython_tpu.render.integrator import render as jax_render
from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu_torch.render import image
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import (
    check_counter_space,
    render,
    render_image,
)
from pathtracerpython_tpu_torch.scene import arrays, synthetic
from torch_parity import to_jax_desc

RTOL = ATOL = 1e-4
MIN_CLOSE = 0.99
SIZE, SPP = 16, 2


@pytest.fixture(scope="module")
def cornell():
    desc = synthetic.cornell_box_scene(SIZE, SIZE)
    return (arrays.pack_scene(desc, pad_to=32, device="cpu"),
            jax_arrays.pack_scene(to_jax_desc(desc), pad_to=32))


def _share_close(got, want):
    close = np.isclose(got, want, rtol=RTOL, atol=ATOL).all(axis=-1)
    return close.mean(), np.abs(got - want).max()


@pytest.mark.parametrize("batch", [True, False])
@pytest.mark.parametrize("bounces", [1, 4])
def test_render_matches_jax(cornell, bounces, batch):
    scene, ref_scene = cornell
    got = render(scene, RenderConfig(n_samples=SPP, n_bounces=bounces,
                                     batch_samples=batch), seed=3).numpy()
    want = np.asarray(jax_render(ref_scene, JaxConfig(
        mode="fast", backend="pallas", accel="none", n_samples=SPP,
        n_bounces=bounces, batch_samples=batch), seed=3))
    share, max_diff = _share_close(got, want)
    print(f"bounces={bounces} batch={batch}: {share:.4f} of pixels close, "
          f"max abs diff {max_diff:.3g}")
    assert got.shape == (SIZE * SIZE, 3) and got.dtype == np.float32
    assert share >= MIN_CLOSE, (share, max_diff)
    assert np.isfinite(got).all() and (got >= 0).all()
    # radiance_to_image: uint8 within 1 of the JAX image on 99% of pixels
    img = image.radiance_to_image(torch.from_numpy(got), SIZE, SIZE)
    ref_img = jax_to_image(want, SIZE, SIZE)
    assert img.shape == ref_img.shape == (SIZE, SIZE, 3)
    off = np.abs(img.astype(int) - ref_img.astype(int)).max(axis=-1)
    assert (off <= 1).mean() >= MIN_CLOSE


@pytest.mark.parametrize("bounces", [1, 4])
def test_render_plans_agree_exactly(cornell, bounces):
    scene, _ = cornell
    cfg = RenderConfig(n_samples=3, n_bounces=bounces, batch_samples=True)
    batched = render(scene, cfg, seed=11)
    looped = render(scene, dataclasses.replace(cfg, batch_samples=False),
                    seed=11)
    assert torch.equal(batched, looped)


def test_background_matches_jax():
    """Misses pay the scene's background with use_background=True."""
    desc = dataclasses.replace(
        synthetic.box_field_scene(n_boxes=8, width=12, height=12),
        background=(0.2, 0.3, 0.4),
    )
    scene = arrays.pack_scene(desc, device="cpu")
    ref_scene = jax_arrays.pack_scene(to_jax_desc(desc))
    got = render(scene, RenderConfig(n_samples=1, n_bounces=2,
                                     use_background=True), seed=0).numpy()
    want = np.asarray(jax_render(ref_scene, JaxConfig(
        mode="fast", backend="pallas", accel="none", n_samples=1,
        n_bounces=2, use_background=True), seed=0))
    share, max_diff = _share_close(got, want)
    assert share >= MIN_CLOSE, (share, max_diff)
    plain = render(scene, RenderConfig(n_samples=1, n_bounces=2), seed=0)
    assert (got > plain.numpy() + 0.1).any()  # some pixels see the sky


@pytest.mark.parametrize("normalization,tonemapping", [
    ("minmax", None), ("clip", None), ("clip", 2.2), ("minmax", 1.0),
])
def test_image_conversion_matches_jax(normalization, tonemapping):
    w, h = 12, 8
    rad = np.random.default_rng(0).uniform(0, 1.5, (w * h, 3)).astype(
        np.float32)
    got = image.radiance_to_image(torch.from_numpy(rad), w, h, normalization,
                                  tonemapping)
    want = jax_to_image(rad, w, h, normalization, tonemapping)
    assert got.dtype == np.uint8 and got.shape == want.shape == (h, w, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    canvas = image.radiance_to_canvas(torch.from_numpy(rad), w, h)
    # pixel (ix, iy) lands at row h-1-iy, column ix
    np.testing.assert_array_equal(canvas[h - 1 - 3, 5].numpy(), rad[5 * h + 3])


def test_render_image_and_save(tmp_path, cornell):
    scene, _ = cornell
    img = render_image(scene, RenderConfig(n_samples=1, n_bounces=1))
    assert img.dtype == np.uint8 and img.shape == (SIZE, SIZE, 3)
    assert img.max() == 255 and img.min() == 0
    path = tmp_path / "out.png"
    image.save_png(img, str(path))
    assert path.stat().st_size > 0


def test_counter_space_is_checked():
    check_counter_space(2**16, 2**15)
    with pytest.raises(ValueError, match="counter"):
        check_counter_space(2**16, 2**16)


def _big_light_desc():
    return dataclasses.replace(
        synthetic.cornell_box_scene(4, 4),
        light_mesh=synthetic.grid_light(6, 6, 3.0, -0.45, 0.45, -24.3,
                                        -22.5),
    )


# Options the first slice refused and the large-scene slice renders: each
# now renders and is held against the JAX package.
NOW_SUPPORTED = {
    "accel_hybrid": dict(accel="hybrid"),
    "accel_auto_large_scene": dict(),
    "light_over_64_tris": dict(),
    "nee_samples_over_8": dict(n_light_samples=9),
    "sort_rays_on": dict(sort_rays="on"),
    # refused until the sparse and walker hierarchies were ported
    "accel_sparse": dict(accel="sparse"),
    "accel_walker": dict(accel="walker"),
    "nee_cache_on": dict(nee_cache="on", accel="sparse"),
    # refused until the soft estimator and remat_bounces were ported
    "soft_visibility": dict(soft_vis_beta=0.05),
    "remat_bounces": dict(remat_bounces=True),
    # refused until the reference estimator was ported; held against JAX
    # mode="reference" (whose sweeps are XLA's whatever the backend)
    "reference_mode": dict(mode="reference"),
}


@pytest.mark.parametrize("case", sorted(NOW_SUPPORTED))
def test_formerly_refused_options_match_jax(case):
    if case == "accel_auto_large_scene":
        # 400 boxes: 4804 triangles >= 4096, so "auto" means the hybrid
        desc = synthetic.box_field_scene(n_boxes=400, width=4, height=4)
        scene = arrays.pack_scene(desc, device="cpu")
        ref_scene = jax_arrays.pack_scene(to_jax_desc(desc))
    else:
        desc = (_big_light_desc() if case == "light_over_64_tris"
                else synthetic.cornell_box_scene(4, 4))
        scene = arrays.pack_scene(desc, pad_to=32, device="cpu")
        ref_scene = jax_arrays.pack_scene(to_jax_desc(desc), pad_to=32)
    kw = dict(n_samples=1, n_bounces=1, **NOW_SUPPORTED[case])
    got = render(scene, RenderConfig(**kw)).numpy()
    want = np.asarray(jax_render(ref_scene, JaxConfig(
        **{"mode": "fast", "backend": "pallas", **kw})))
    share, max_diff = _share_close(got, want)
    assert share >= MIN_CLOSE, (share, max_diff)
    assert np.isfinite(got).all() and got.max() > 0


# option -> config of what the port refused until it ported it; the soft
# estimator on a geometry ring renders since the soft sweeps stream around
# the ring (parallel/ring.py; rings of several ranks are held in
# tests/test_torch_soft_ring.py)
UNSUPPORTED = {
    "geom_axis": dict(soft_vis_beta=0.05),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unsupported_options_raise(case):
    """Nothing raises any more: the option renders, here on a ring of one
    rank, bit-equal to the unsharded render."""
    from pathtracerpython_tpu_torch.parallel import make_mesh, render_sharded

    scene = arrays.pack_scene(synthetic.cornell_box_scene(4, 4), pad_to=32,
                              device="cpu")
    cfg = RenderConfig(n_samples=1, n_bounces=1, **UNSUPPORTED[case])
    with torch.no_grad():
        got = render_sharded(scene, cfg, make_mesh(device="cpu"),
                             geom_axis="geom")
        want = render(scene, cfg)
    assert want.max() > 0
    assert torch.equal(got, want)
