"""The port's fast-mode sampling primitives against the JAX package's
``ops/sampling.py`` on the same numpy inputs.

Tolerances: the light pick is an integer and must be equal. The float
functions run the same float32 operations, but XLA:CPU may fuse a product
into an add, and its rsqrt, sin and cos are not rounded like PyTorch's, so
they agree to a few ulps of values of size <= ~10: rtol = atol = 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.ops import sampling as jax_sampling
from pathtracerpython_tpu_torch.ops import sampling

RTOL = ATOL = 1e-6
N = 4096


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: with one intra-op thread these tests take
    the same time alone and do not fight the other test workers for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _unit_normals(n, seed):
    v = _rng(seed).normal(size=(3, n)).astype(np.float32)
    v /= np.linalg.norm(v, axis=0, keepdims=True)
    v[:, :4] = [[0, 0, 0, 1], [0, 0, 1, 0], [1, -1, 0, 0]]  # poles, axes
    return v


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("n_tris", [1, 2, 8, 64])
def test_pick_light_triangle_equal(n_tris):
    rs = _rng(n_tris)
    areas = rs.uniform(0.1, 2.0, n_tris).astype(np.float32)
    u = rs.uniform(size=N).astype(np.float32)
    u[:3] = [0.0, np.nextafter(np.float32(1), np.float32(0)), 0.5]
    got = sampling.pick_light_triangle(torch.from_numpy(u),
                                       torch.from_numpy(areas))
    want = np.asarray(jax_sampling.pick_light_triangle(jnp.asarray(u),
                                                       jnp.asarray(areas)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.min() >= 0 and got.max() < n_tris


def test_barycentric_sampling_and_point():
    rs = _rng(1)
    u2 = rs.uniform(size=(2, N)).astype(np.float32)
    v = [rs.normal(size=(3, N)).astype(np.float32) for _ in range(3)]
    bary = sampling.cm_sample_barycentric_uniform(torch.from_numpy(u2))
    jbary = jax_sampling.cm_sample_barycentric_uniform(jnp.asarray(u2))
    _close(bary, jbary)
    assert torch.allclose(bary.sum(0), torch.ones(N), atol=1e-6)
    point = sampling.cm_point_from_barycentric(
        bary, *(torch.from_numpy(a) for a in v))
    jpoint = jax_sampling.cm_point_from_barycentric(
        jbary, *(jnp.asarray(a) for a in v))
    _close(point, jpoint)


def test_onb_and_cosine_hemisphere():
    n3 = _unit_normals(N, 2)
    u2 = _rng(3).uniform(size=(2, N)).astype(np.float32)
    t3, b3 = sampling.cm_build_onb(torch.from_numpy(n3))
    jt3, jb3 = jax_sampling.cm_build_onb(jnp.asarray(n3))
    _close(t3, jt3)
    _close(b3, jb3)
    d3 = sampling.cm_cosine_hemisphere_fixed(torch.from_numpy(u2),
                                             torch.from_numpy(n3))
    jd3 = jax_sampling.cm_cosine_hemisphere_fixed(jnp.asarray(u2),
                                                  jnp.asarray(n3))
    _close(d3, jd3)
    # unit directions in the hemisphere about the normal
    assert torch.allclose(sampling.cm_dot(d3, d3), torch.ones(N), atol=1e-5)
    assert bool((sampling.cm_dot(d3, torch.from_numpy(n3)) >= -1e-6).all())


def test_reflect_normalize_dot():
    rs = _rng(4)
    d3 = rs.normal(size=(3, N)).astype(np.float32)
    d3[:, 0] = 0.0  # zero vector: normalize maps it to zero
    n3 = _unit_normals(N, 5)
    td, tn = torch.from_numpy(d3), torch.from_numpy(n3)
    _close(sampling.cm_dot(td, tn), jax_sampling.cm_dot(jnp.asarray(d3),
                                                        jnp.asarray(n3)))
    unit = sampling.cm_normalize(td)
    _close(unit, jax_sampling.cm_normalize(jnp.asarray(d3)))
    assert torch.equal(unit[:, 0], torch.zeros(3))
    _close(sampling.cm_reflect(td, tn),
           jax_sampling.cm_reflect(jnp.asarray(d3), jnp.asarray(n3)))
