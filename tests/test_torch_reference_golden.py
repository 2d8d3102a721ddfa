"""The port's reference-mode render against radiance captured from the
reference program itself (``tests/golden/*.npz``, written by
``scripts/generate_reference_golden.py``): the gates of
``tests/test_reference_parity.py``, on the port's render on the CPU.

The goldens are renders of the reference's ``objs/cornellroom.sdl`` (32
triangles), which is not in the repository; the in-repo stand-in is a
different scene. So every test here skips unless the reference checkout
that ``conftest.py`` names (``REFERENCE_DIR``) holds it, and the port is
held to the JAX package on the stand-in in
``test_torch_reference_render.py``.

RNG streams differ (CPython's Mersenne twister against counter-based
Threefry), so converged renders are compared statistically, with the
tolerances of the JAX tests: the Monte-Carlo means of both estimators are
the same quantity, so their per-pixel difference shrinks as 1/sqrt(S).
The deterministic structure (which pixels see the light, which see
nothing) must match exactly."""

import os
import shutil

import numpy as np
import pytest
import torch

from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import render
from pathtracerpython_tpu_torch.scene.arrays import load_scene
from conftest import CORNELL_SDL

REFERENCE_OBJS = os.path.dirname(CORNELL_SDL)
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the other test workers keep their cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cornell():
    if not os.path.exists(CORNELL_SDL):
        pytest.skip(f"the reference scene {CORNELL_SDL} is not present")
    return load_scene(CORNELL_SDL, device="cpu")


def _golden(r, b, seed=9, suffix=""):
    path = os.path.join(GOLDEN_DIR,
                        f"reference_r{r}_b{b}_seed{seed}{suffix}.npz")
    if not os.path.exists(path):
        pytest.skip(f"golden not generated: {path}")
    return np.load(path)["radiance"]  # [W*H, 3] float64, x-outer order


def _renders(scene, spp: int, bounces: int, seeds) -> list[np.ndarray]:
    cfg = RenderConfig(mode="reference", n_samples=spp, n_bounces=bounces)
    return [render(scene, cfg, seed=s).numpy() for s in seeds]


def _d_self(ours) -> float:
    return float(np.mean([np.abs(ours[i] - ours[j]).mean()
                          for i, j in ((0, 1), (0, 2), (1, 2))]))


def test_light_pixels_and_black_pixels_match_exactly(cornell):
    golden = _golden(1, 1)
    ours = _renders(cornell, 1, 1, [0])[0]
    np.testing.assert_array_equal(np.all(ours == 1.0, axis=1),
                                  np.all(golden == 1.0, axis=1))
    np.testing.assert_array_equal(np.all(ours == 0.0, axis=1),
                                  np.all(golden == 0.0, axis=1))


def test_converged_radiance_allclose_b1(cornell):
    golden = _golden(64, 1)
    ours = _renders(cornell, 64, 1, [9])[0]
    diff = np.abs(ours - golden)
    assert diff.mean() < 0.01, diff.mean()
    assert np.quantile(diff, 0.99) < 0.08, np.quantile(diff, 0.99)
    corr = np.corrcoef(ours.ravel(), golden.ravel())[0, 1]
    assert corr > 0.998, corr


@pytest.mark.parametrize("bounces", [2, 4])
def test_converged_radiance_bias_bound(cornell, bounces):
    """Three reference captures (seeds 9-11) against three of the port's
    seeds: for unbiased estimators E|O - R| = d_self / sqrt(3); the 1.15
    margin bounds a systematic bias (the JAX tests' b2 and b4 gates)."""
    goldens = [_golden(64, bounces, seed=s) for s in (9, 10, 11)]
    ours = _renders(cornell, 64, bounces, (9, 123, 456))
    ours_mean, gold_mean = np.mean(ours, axis=0), np.mean(goldens, axis=0)
    diff = np.abs(ours_mean - gold_mean)
    assert diff.mean() < _d_self(ours) / np.sqrt(3.0) * 1.15
    corr = np.corrcoef(ours_mean.ravel(), gold_mean.ravel())[0, 1]
    if bounces == 2:
        assert corr > 0.999, corr
    else:
        rho = np.mean([np.corrcoef(ours[i].ravel(), ours[j].ravel())[0, 1]
                       for i, j in ((0, 1), (0, 2), (1, 2))])
        expected = 1.0 / (1.0 + (1.0 - rho) / (3.0 * rho))
        assert corr > expected - 5e-4, (corr, expected, rho)


def test_baseline_config0_shape(tmp_path):
    """BASELINE configs[0]: 128x128, 16 spp, 2 bounces, against the
    captures at that size, both sides averaged over their seeds."""
    if not os.path.exists(CORNELL_SDL):
        pytest.skip(f"the reference scene {CORNELL_SDL} is not present")
    goldens = [np.load(p)["radiance"] for p in (
        os.path.join(GOLDEN_DIR, f"reference_r16_b2_seed{s}_128x128.npz")
        for s in (9, 10, 11)) if os.path.exists(p)]
    if not goldens:
        pytest.skip("no 128x128 goldens generated")
    sdl_dir = tmp_path / "objs"
    shutil.copytree(REFERENCE_OBJS, sdl_dir)
    sdl = sdl_dir / "cornellroom.sdl"
    text = sdl.read_text().replace("size 40 40", "size 128 128")
    assert "size 128 128" in text
    sdl.write_text(text)
    scene = load_scene(str(sdl), device="cpu")
    ours = _renders(scene, 16, 2, (9, 123, 456))
    m, k = len(ours), len(goldens)
    floor = _d_self(ours) * np.sqrt((1.0 / m + 1.0 / k) / 2.0)
    diff = np.abs(np.mean(ours, axis=0) - np.mean(goldens, axis=0))
    assert diff.mean() < floor * 1.05, (diff.mean(), floor, m, k)
    corr = np.corrcoef(np.mean(ours, axis=0).ravel(),
                       np.mean(goldens, axis=0).ravel())[0, 1]
    self_corr = np.corrcoef(ours[0].ravel(), ours[1].ravel())[0, 1]
    assert corr > self_corr - 0.002, (corr, self_corr)
