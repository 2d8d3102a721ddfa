"""Wavefront ordering (``ops/sort.py``): the port's morton keys, scene bounds
and sort permutations against the JAX package's, bit for bit, and the
integrator's unscramble of sorted lanes. Inputs are made with numpy and
handed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.ops import sort as jax_sort
from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu_torch.ops import sort
from pathtracerpython_tpu_torch.render import integrator
from pathtracerpython_tpu_torch.scene import arrays, synthetic
from torch_parity import to_jax_desc


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: with one intra-op thread these tests take
    the same time alone and do not fight the other test workers for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def field():
    desc = synthetic.box_field_scene(n_boxes=80, width=24, height=24)
    return (arrays.pack_scene(desc, tri_order="morton", device="cpu"),
            jax_arrays.pack_scene(to_jax_desc(desc), morton_order=True))


def _wavefront(n, seed, dead_share=0.3):
    """Origins inside and around the field, unnormalized directions with
    some axis-aligned and zero components (octant edge cases), and dead
    lanes."""
    rs = np.random.default_rng(seed)
    o3 = rs.uniform([-10, -2, -18], [10, 3, 4], (n, 3)).astype(np.float32).T
    d3 = (rs.normal(size=(n, 3)) * rs.uniform(0.1, 3.0, (n, 1))).astype(
        np.float32).T.copy()
    d3[0, ::17] = 0.0
    d3[1, ::23] = -0.0
    alive = rs.uniform(size=n) > dead_share
    hint = rs.uniform(size=n) > 0.5
    return np.ascontiguousarray(o3), d3, alive, hint


def test_morton3_matches_jax():
    q3 = np.random.default_rng(0).integers(0, 1024, (3, 4096)).astype(
        np.uint32)
    got = sort.morton3(torch.from_numpy(q3.astype(np.int64))).numpy()
    want = np.asarray(jax_sort.morton3(jnp.asarray(q3)))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got.max() < 2**30


def test_scene_bounds_match_jax(field):
    scene, ref = field
    lo, hi = sort.scene_bounds(scene)
    jlo, jhi = jax_sort.scene_bounds(ref)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


@pytest.mark.parametrize("with_hint", [False, True])
@pytest.mark.parametrize("dead_share", [0.0, 0.3])
def test_sort_order_matches_jax(field, with_hint, dead_share):
    scene, ref = field
    o3, d3, alive, hint = _wavefront(3000, seed=7, dead_share=dead_share)
    lo, hi = sort.scene_bounds(scene)
    got = sort.wavefront_sort_order(
        torch.from_numpy(o3), torch.from_numpy(d3), torch.from_numpy(alive),
        lo, hi, occ_hint=torch.from_numpy(hint) if with_hint else None)
    jlo, jhi = jax_sort.scene_bounds(ref)
    want = jax_sort.wavefront_sort_order(
        jnp.asarray(o3), jnp.asarray(d3), jnp.asarray(alive), jlo, jhi,
        occ_hint=jnp.asarray(hint) if with_hint else None)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a permutation with every dead lane at the end
    assert sorted(got.tolist()) == list(range(3000))
    n_alive = int(alive.sum())
    assert alive[got.numpy()[:n_alive]].all()


def test_permute_minor_matches_jax():
    x = np.random.default_rng(1).normal(size=(3, 50)).astype(np.float32)
    order = np.random.default_rng(2).permutation(50)
    got = sort.permute_minor(torch.from_numpy(x), torch.from_numpy(order))
    want = jax_sort.permute_minor(jnp.asarray(x), jnp.asarray(order))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("batched", [True, False])
def test_sort_permute_unscramble_returns_every_lane(field, batched):
    """Sort the lanes of a render's state twice, then unscramble by the
    counters: every lane's radiance comes back to its own slot."""
    scene, _ = field
    n, spp = 600, 3 if batched else 1
    o3, d3, alive, _ = _wavefront(n * spp, seed=3)
    pid = torch.arange(n, dtype=torch.int64)
    sample = 1 if not batched else None
    counters = (torch.cat([pid * spp + s for s in range(spp)]) if batched
                else pid * 3 + sample)
    state = integrator.init_rays(torch.from_numpy(o3), torch.from_numpy(d3),
                                 counters)
    marks = torch.arange(n * spp, dtype=torch.float32)
    state = state._replace(radiance3=marks.expand(3, -1).clone(),
                           alive=torch.from_numpy(alive))
    lo, hi = sort.scene_bounds(scene)
    for sign in (1.0, -1.0):  # two different keys, two real permutations
        order = sort.wavefront_sort_order(state.origin3,
                                          sign * state.direction3,
                                          state.alive, lo, hi)
        assert not torch.equal(order, torch.arange(n * spp))
        state = integrator.RayState(
            *(sort.permute_minor(f, order) for f in state))
    back = integrator._unscramble(state)
    assert torch.equal(back, marks.expand(3, -1))
