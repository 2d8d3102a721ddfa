"""The port's reference-mode samplers (``ops/sampling.py``) and the
integrator's ``_power_numpy_semantics`` against the JAX package's, on
seeded uniforms, normals and bases.

Tolerances: the same float32 operations in the same order, but XLA:CPU's
arccos, sin, cos, pow and rsqrt round differently from PyTorch's in the
last bits, so results agree to atol = 1e-6 (values of order 1) and
rtol = 1e-5 for powers; divisions and products alone (the barycentrics)
are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.ops import sampling as jsm
from pathtracerpython_tpu.render.integrator import (
    _power_numpy_semantics as jax_power,
)
from pathtracerpython_tpu_torch.ops import sampling as sm
from pathtracerpython_tpu_torch.render.integrator import (
    _power_numpy_semantics,
)

ATOL = 1e-6
POW_RTOL = 1e-5
N = 4096


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the time of a test alone and
    leaves the other test workers their cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _uniforms(shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _unit_normals(n: int, seed: int) -> np.ndarray:
    """Seeded unit normals, with the axis-aligned ones of a Cornell room
    (y-facing floors and ceilings, where the frame is right) among them."""
    v = np.random.default_rng(seed).normal(size=(n, 3))
    v[:6] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0], [0, 0, 1],
             [0, 0, -1]]
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _close(got: torch.Tensor, want, atol: float = ATOL) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def test_tau_reference_is_the_truncated_two_pi():
    assert sm.TAU_REFERENCE == jsm.TAU_REFERENCE == 6.28


def test_barycentrics_and_points_match_jax():
    u3 = _uniforms((N, 3), 0)
    got = sm.sample_barycentric_reference(torch.from_numpy(u3))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsm.sample_barycentric_reference(u3)))
    np.testing.assert_allclose(got.numpy().sum(axis=-1), 1.0, atol=1e-6)
    cm = sm.cm_sample_barycentric_reference(torch.from_numpy(u3.T.copy()))
    np.testing.assert_array_equal(
        cm.numpy(), np.asarray(jsm.cm_sample_barycentric_reference(u3.T)))
    np.testing.assert_array_equal(cm.numpy(), got.numpy().T)
    v = np.random.default_rng(1).normal(size=(3, N, 3)).astype(np.float32)
    pts = sm.point_from_barycentric(got, *(torch.from_numpy(a) for a in v))
    _close(pts, jsm.point_from_barycentric(np.asarray(got), *v))


def test_rotations_match_jax():
    angle = np.random.default_rng(2).uniform(0, np.pi, N).astype(np.float32)
    _close(sm.rotation_about_y(torch.from_numpy(angle)),
           jsm.rotation_about_y(angle))
    normals = _unit_normals(N, 3)
    vecs = np.random.default_rng(4).normal(size=(N, 3)).astype(np.float32)
    row = sm.rotate_frame_reference(torch.from_numpy(vecs),
                                    torch.from_numpy(normals))
    _close(row, jsm.rotate_frame_reference(vecs, normals))
    cm = sm.cm_rotate_frame_reference(torch.from_numpy(vecs.T.copy()),
                                      torch.from_numpy(normals.T.copy()))
    _close(cm, jsm.cm_rotate_frame_reference(vecs.T, normals.T))
    # each form as written: the component-major one passes v[1] through,
    # the matrix multiplies it by aa + cc, which is 1 up to rounding
    np.testing.assert_array_equal(cm.numpy()[1], vecs[:, 1])
    np.testing.assert_allclose(row.numpy()[:, 1], vecs[:, 1], atol=1e-6)
    _close(cm.T, row.numpy())


def test_cosine_hemisphere_reference_matches_jax():
    u2 = _uniforms((N, 2), 5)
    row = sm.cosine_hemisphere_reference(torch.from_numpy(u2))
    _close(row, jsm.cosine_hemisphere_reference(u2))
    cm = sm.cm_cosine_hemisphere_reference(torch.from_numpy(u2.T.copy()))
    _close(cm, jsm.cm_cosine_hemisphere_reference(u2.T))
    np.testing.assert_array_equal(cm.numpy(), row.numpy().T)
    np.testing.assert_allclose(np.linalg.norm(row.numpy(), axis=-1), 1.0,
                               atol=1e-6)
    assert (row.numpy()[:, 2] >= 0).all()


@pytest.mark.parametrize("exponent", [1.0, 2.0, 3.0, 5.0, 0.5, 2.5, 7.3])
def test_power_numpy_semantics(exponent):
    """A negative base keeps its sign parity under an integral exponent and
    is NaN under a fractional one, as numpy's float power: against the JAX
    function and numpy itself."""
    base = np.random.default_rng(6).uniform(-1.5, 1.5, N).astype(np.float32)
    base[:3] = [0.0, -0.0, 1.0]
    exp = np.full(N, exponent, np.float32)
    got = _power_numpy_semantics(torch.from_numpy(base),
                                 torch.from_numpy(exp)).numpy()
    want = np.asarray(jax_power(jnp.asarray(base), jnp.asarray(exp)))
    with np.errstate(invalid="ignore"):
        ref = np.power(base.astype(np.float64), exponent)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(got)
    np.testing.assert_allclose(got[ok], want[ok], rtol=POW_RTOL, atol=1e-7)
    np.testing.assert_allclose(got[ok], ref[ok], rtol=POW_RTOL, atol=1e-7)
    negative = base < 0
    if exponent == int(exponent):
        assert not np.isnan(got).any()
        sign = -1.0 if int(exponent) % 2 else 1.0
        assert (np.sign(got[negative]) == sign).all()
    else:
        assert np.isnan(got[negative]).all()
