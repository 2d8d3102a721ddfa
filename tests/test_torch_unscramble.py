"""Sorting only orders lanes: ``render_rays`` returns its rays' radiance in
the INPUT order for any distinct pixel ids, sorted or not, in both sample
plans (the repaired ``render/integrator.py:_unscramble``, which puts each
lane back at its place in the wavefront, carried as ``RayState.lane``).

The scene and settings of ROADMAP.md queue C's run: ``box_field_scene(
n_boxes=8, width=8, height=8)``, 1 and 2 spp, 2 bounces, ``sort_rays="on"``
against ``"off"``, with the 64 pixel ids permuted (rays permuted with
them) and with one shard's range ``arange(32) + 32``; both bit-equal to
the rows of the whole image's render. The JAX package's unscramble names
each lane's slot by its pixel id, so there the permuted render comes back
in pixel order and the shifted range is dropped; ``test_jax_sorted_*``
assert that fault, which the JAX side keeps (queue C).

Tolerance: none (bit-equal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.ops.camera import make_primary_rays as jax_rays
from pathtracerpython_tpu.render.config import RenderConfig as JaxConfig
from pathtracerpython_tpu.render.integrator import render_rays as jax_rr
from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import render, render_rays
from pathtracerpython_tpu_torch.scene.arrays import pack_scene
from pathtracerpython_tpu_torch.scene.synthetic import box_field_scene
from torch_parity import to_jax_desc

SIZE = 8
N = SIZE * SIZE


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def desc():
    return box_field_scene(n_boxes=8, width=SIZE, height=SIZE)


@pytest.fixture(scope="module")
def scene(desc):
    return pack_scene(desc, device="cpu")


def _ids(kind: str) -> torch.Tensor:
    """The pixel ids of each input: a permutation of the image, or the
    second half of it (one of two shards' range)."""
    if kind == "permuted":
        return torch.from_numpy(np.random.default_rng(7).permutation(N))
    return torch.arange(N // 2) + N // 2


def _cfg(sort: str, spp: int, batched: bool) -> RenderConfig:
    return RenderConfig(n_samples=spp, n_bounces=2, sort_rays=sort,
                        batch_samples=batched)


PLANS = [(1, False), (2, False), (2, True)]


@pytest.mark.parametrize("spp,batched", PLANS)
@pytest.mark.parametrize("kind", ["permuted", "shifted"])
def test_sorted_render_keeps_input_order(scene, kind, spp, batched):
    o, d = make_primary_rays(scene.eye, scene.ortho, SIZE, SIZE)
    ids = _ids(kind)
    with torch.no_grad():
        whole = render(scene, _cfg("off", spp, batched), seed=3)
        got = {sort: render_rays(o[ids], d[ids], ids, scene,
                                 _cfg(sort, spp, batched), 3)
               for sort in ("on", "off")}
    assert torch.equal(got["on"], got["off"])
    assert torch.equal(got["on"], whole[ids])
    assert float(got["on"].max()) > 0


@pytest.mark.parametrize("spp,batched", PLANS)
def test_identity_ids_sorted_equal_unsorted(scene, spp, batched):
    """With ``arange(n)`` ids the sorted render is the unsorted one bit for
    bit, as before the repair (the lane's place is then its pixel id)."""
    with torch.no_grad():
        on = render(scene, _cfg("on", spp, batched), seed=5)
        off = render(scene, _cfg("off", spp, batched), seed=5)
    assert torch.equal(on, off)


def _jax_render(desc, ids: np.ndarray, sort: str):
    ref = jax_arrays.pack_scene(to_jax_desc(desc))
    o, d = jax_rays(ref.eye, ref.ortho, SIZE, SIZE)
    cfg = JaxConfig(mode="fast", backend="xla", n_samples=1, n_bounces=2,
                    sort_rays=sort)
    j = jnp.asarray(ids)
    return np.asarray(jax_rr(o[j], d[j], j.astype(jnp.int32), ref, cfg,
                             jax.random.PRNGKey(3)))


def test_jax_sorted_permuted_ids_come_back_in_pixel_order(desc):
    ids = _ids("permuted").numpy()
    off = _jax_render(desc, ids, "off")
    on = _jax_render(desc, ids, "on")
    assert not np.array_equal(on, off)
    # row p of the sorted render is the lane of pixel p
    np.testing.assert_array_equal(on[ids], off)


def test_jax_sorted_shifted_ids_are_dropped(desc):
    ids = _ids("shifted").numpy()
    off = _jax_render(desc, ids, "off")
    on = _jax_render(desc, ids, "on")
    assert off.max() > 0
    assert not on.any()
