"""The port's Threefry RNG and camera against the JAX package: bit-equal.

Equal bits here are what make the two renders draw the same random numbers
for the same path and shoot the same primary rays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.ops import camera as jax_camera
from pathtracerpython_tpu.ops import rng as jax_rng
from pathtracerpython_tpu_torch.ops import camera, rng

SEEDS = [0, 1, 7, 2**31 - 1, 2**31 + 5, 2**32 - 1, 2**32 + 3, 2**40 + 12345]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: with one intra-op thread these tests take
    the same time alone and do not fight the other test workers for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _words(n, seed):
    return np.random.default_rng(seed).integers(0, 2**32, n, dtype=np.uint64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_from_seed_matches_jax(seed):
    k0, k1 = jax_rng.key_from_seed(seed)
    assert rng.key_from_seed(seed) == (int(k0), int(k1))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_and_uniforms_bit_equal(seed):
    jk = jax_rng.key_from_seed(seed)
    pk = rng.key_from_seed(seed)
    counters = _words(4096, seed % 1000)
    counters[:4] = [0, 2**31 - 1, 2**31, 2**32 - 1]  # word edges
    for salt in (0, 1, 13, 4 * 3 + 1, 2**31 + 7):
        jf = jax_rng.fold(jk[0], jk[1], salt)
        pf = rng.fold(*pk, salt)
        assert pf == (int(jf[0]), int(jf[1]))
        for n_draws in (3, 15):
            want = np.asarray(jax_rng.uniforms(
                jf[0], jf[1], jnp.asarray(counters.astype(np.uint32)), n_draws
            ))
            got = rng.uniforms(*pf, torch.from_numpy(counters.astype(np.int64)),
                               n_draws).numpy()
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)


def test_threefry_on_tensors_and_ints_matches_jax():
    keys = _words(6, 11)
    x0, x1 = _words(2048, 12), _words(2048, 13)
    for k0, k1 in zip(keys[::2], keys[1::2]):
        j0, j1 = jax_rng.threefry2x32(
            jnp.uint32(k0), jnp.uint32(k1),
            jnp.asarray(x0.astype(np.uint32)), jnp.asarray(x1.astype(np.uint32)),
        )
        p0, p1 = rng.threefry2x32(int(k0), int(k1),
                                  torch.from_numpy(x0.astype(np.int64)),
                                  torch.from_numpy(x1.astype(np.int64)))
        np.testing.assert_array_equal(p0.numpy(), np.asarray(j0).astype(np.int64))
        np.testing.assert_array_equal(p1.numpy(), np.asarray(j1).astype(np.int64))
        # the scalar path (used to derive keys) agrees with the tensor path
        s0, s1 = rng.threefry2x32(int(k0), int(k1), int(x0[5]), int(x1[5]))
        assert (s0, s1) == (int(p0[5]), int(p1[5]))


def test_unit_interval_edges():
    bits = torch.tensor([0, 2**9 - 1, 2**9, 2**31, 2**32 - 1], dtype=torch.int64)
    want = np.asarray(jax_rng._to_unit_interval(
        jnp.asarray(bits.numpy().astype(np.uint32))))
    got = rng._to_unit_interval(bits).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0.0 and got.max() < 1.0


@pytest.mark.parametrize("size", [(40, 40), (512, 512), (16, 16), (32, 24)])
def test_primary_rays_bit_equal(size):
    w, h = size
    eye = np.asarray([0.0, 0.0, 5.7], np.float32)
    ortho = np.asarray([-1.0, -1.0, 1.0, 1.0], np.float32)
    jo, jd = jax_camera.make_primary_rays(jnp.asarray(eye), jnp.asarray(ortho),
                                          w, h)
    po, pd = camera.make_primary_rays(torch.from_numpy(eye),
                                      torch.from_numpy(ortho), w, h)
    assert tuple(pd.shape) == (w * h, 3)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


@pytest.mark.parametrize("bounds", [(-1.0, 1.0), (-0.7, 1.3), (0.25, 3.5)])
def test_linspace_bit_equal(bounds):
    """The port's linspace reproduces jnp.linspace on the CPU bit for bit,
    across the point counts where XLA switches code shapes."""
    a, b = bounds
    for num in (1, 2, 3, 4, 16, 33, 34, 35, 40, 100, 352, 353, 354, 512,
                1000):
        want = np.asarray(jnp.linspace(jnp.float32(a), jnp.float32(b), num))
        got = camera.linspace(torch.tensor(a), torch.tensor(b), num).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"num={num}")
