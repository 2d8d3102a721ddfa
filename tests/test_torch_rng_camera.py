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
        for n_draws in (1, 3, 5, 15):  # odd counts: the tail's lone y0
            want = np.asarray(jax_rng.uniforms(
                jf[0], jf[1], jnp.asarray(counters.astype(np.uint32)), n_draws
            ))
            got = rng.uniforms(*pf, torch.from_numpy(counters.astype(np.int64)),
                               n_draws).numpy()
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("layout", ["int64", "int32", "strided", "2d"])
def test_uniforms_counter_layouts_match_jax(layout):
    """The draws follow the counter words' low 32 bits, whatever the
    integer type and strides: int32 words past 2^31 read as negative,
    int64 words above 2^32 or below 0 keep their low bits; the output is
    [n_draws, *counters.shape]."""
    words = _words(1200, 21)
    words[:4] = [0, 2**31 - 1, 2**31, 2**32 - 1]
    jk = jax_rng.fold(*jax_rng.key_from_seed(9), 4 * 2 + 1)
    want = np.asarray(jax_rng.uniforms(
        jk[0], jk[1], jnp.asarray(words.astype(np.uint32)), 5))
    wide = torch.from_numpy(words.astype(np.int64))
    if layout == "int64":
        counters = wide + torch.from_numpy(
            np.random.default_rng(22).integers(-3, 4, words.size) << 32)
    elif layout == "int32":
        counters = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    elif layout == "strided":
        counters = torch.stack([wide, wide + 7], dim=1)[:, 0]
        assert not counters.is_contiguous()
    else:
        counters = wide.reshape(30, 40).T
        want = want.reshape(5, 30, 40).transpose(0, 2, 1)
    got = rng.uniforms(int(jk[0]), int(jk[1]), counters, 5)
    assert tuple(got.shape) == (5, *counters.shape)
    np.testing.assert_array_equal(got.numpy(), want)


def test_uniforms_on_the_cpu_never_touches_the_library(monkeypatch):
    """A CPU tensor takes the plain version: with the library's loader
    raising, the call still works, equals ``uniforms_plain`` and launches
    nothing."""
    from pathtracerpython_tpu_torch.kernels import build

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path reached the CUDA library")

    monkeypatch.setattr(build, "function", refuse)
    before = rng.LAUNCHES
    counters = torch.from_numpy(_words(777, 31).astype(np.int64))
    for n_draws in (1, 2, 15):
        got = rng.uniforms(5, 6, counters, n_draws)
        assert torch.equal(got, rng.uniforms_plain(5, 6, counters, n_draws))
    assert rng.LAUNCHES == before


@pytest.mark.parametrize("case,message", [
    ("cpu_tensor", "not on a card"), ("float_counters", "int32 or int64"),
    ("int16_counters", "int32 or int64"), ("no_draws", "at least 1")])
def test_uniforms_cuda_refuses_what_the_kernel_does_not_take(case, message,
                                                             monkeypatch):
    """The kernel's wrapper raises before it loads the library: a CPU
    tensor, counters neither int32 nor int64, fewer than one draw."""
    from pathtracerpython_tpu_torch.kernels import build

    def refuse(*args, **kwargs):
        raise AssertionError("the wrapper loaded the library")

    monkeypatch.setattr(build, "function", refuse)
    counters, n_draws = torch.arange(8), 3
    if case == "float_counters":
        counters = counters.float()
    elif case == "int16_counters":
        counters = counters.to(torch.int16)
    elif case == "no_draws":
        n_draws = 0
    with pytest.raises(ValueError, match=message):
        rng.uniforms_cuda(1, 2, counters, n_draws)


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
