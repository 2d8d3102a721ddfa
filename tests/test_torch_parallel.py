"""The port's sharded renders (``parallel/shard.py``) on gloo ranks on the
CPU: data-parallel renders (per-sample and batch_samples plans, a pixel
count that the shards do not divide, reference mode, a large scene through
the hybrid with wavefront and NEE sorting on) bit-equal to the port's
single-process render (the sorted large scene also over 4 ranks);
geometry-ring renders (2 and 4 shards, dp x geom on 4 ranks, fast and
reference) within 1e-6 of it; and the JAX package's
``render_sharded`` on its virtual CPU mesh (sorting off) against the
port's sharded render.

Tolerances: dp renders run the single-process render's lanes with their
own counters, so they are bit-equal. A ring merges per-shard winners by
(key, global row), so it names the same winners; 1e-6 absolute is the
stated bound. Against JAX (its Pallas kernels in interpret mode) the
tolerance of tests/test_torch_render.py: rtol = atol = 1e-4 on 99% of
pixels (XLA:CPU's rsqrt, sin and cos round differently in the last bit).
The large sorted render is held to the port's single render only: the JAX
sharded render drops every shard but the first when sorting is on
(ROADMAP.md queue C)."""

import jax
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.parallel import make_mesh as jax_make_mesh
from pathtracerpython_tpu.parallel import render_sharded as jax_sharded
from pathtracerpython_tpu.render.config import RenderConfig as JaxConfig
from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu_torch.parallel import (
    make_mesh,
    multihost,
    render_sharded,
)
from pathtracerpython_tpu_torch.render.integrator import render
from pathtracerpython_tpu_torch.scene.synthetic import cornell_box_scene
from torch_parallel_worker import render_cases, spawn_ranks
from torch_parity import to_jax_desc

WORLDS = (2, 4)
RING_ATOL = 1e-6
JAX_RTOL = JAX_ATOL = 1e-4
MIN_CLOSE = 0.99


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {w: spawn_ranks("render", w,
                           str(tmp_path_factory.mktemp(f"render{w}")))
            for w in WORLDS}


@pytest.fixture(scope="module")
def singles():
    """case -> the single-process render of each world's cases."""
    out = {}
    for w in WORLDS:
        for name, (scene, cfg, _, _) in render_cases(w).items():
            if name not in out:
                with torch.no_grad():
                    out[name] = render(scene, cfg, seed=3).numpy()
    return out


def _cases(ring: bool):
    return [(w, name) for w in WORLDS for name in render_cases(w)
            if ("ring" in name) == ring]


@pytest.mark.parametrize("world,name", _cases(ring=False))
def test_dp_render_bit_equals_single(ranks, singles, world, name):
    want = singles[name]
    assert np.isfinite(want).all() and want.max() > 0
    for rank in ranks[world]:
        np.testing.assert_array_equal(rank[name], want)


@pytest.mark.parametrize("world,name", _cases(ring=True))
def test_ring_render_matches_single(ranks, singles, world, name):
    want = singles[name]
    for rank in ranks[world]:
        got = rank[name]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=RING_ATOL)


@pytest.mark.parametrize("world", WORLDS)
def test_fetch_to_host_gathers_every_rank(ranks, world):
    want = np.repeat(np.arange(world, dtype=np.float32), 2)
    for rank in ranks[world]:
        np.testing.assert_array_equal(rank["fetch"], want)


def test_large_sorted_case_sorts_and_pads():
    """The large case runs the hybrid with sorting on, on 49 rays that 2
    and 4 shards do not divide: the path that needs the repaired
    unscramble."""
    scene, cfg, _, _ = render_cases(2)["dp_large_sorted"]
    assert scene.num_padded_triangles >= 4096 and cfg.sort_rays == "on"
    assert (scene.meta.width * scene.meta.height) % 2 == 1


def test_degenerate_mesh_renders_alone():
    """A world of one needs no process group: the mesh is (1, 1) and the
    sharded render is the single render."""
    from pathtracerpython_tpu_torch.render.config import RenderConfig
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene

    scene = pack_scene(cornell_box_scene(6, 6), pad_to=32, device="cpu")
    mesh = make_mesh()
    assert mesh.shape == {"dp": 1, "geom": 1} and mesh.size == 1
    cfg = RenderConfig(n_samples=2, n_bounces=2)
    with torch.no_grad():
        a = render_sharded(scene, cfg, mesh, seed=4, geom_axis="geom")
        b = render(scene, cfg, seed=4)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="world has 1"):
        make_mesh(dp=2)


@pytest.fixture
def cards(monkeypatch):
    """Pretend the host has ``n`` cards: ``cards(n)``."""
    def pretend(n: int):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    return pretend


def test_nccl_on_a_shared_card_raises(cards, tmp_path):
    """Two ranks on a host of one card share it: NCCL refuses two ranks on
    one device, so asking for it raises before the group is joined."""
    cards(1)
    with pytest.raises(ValueError, match="card of its own"):
        multihost.initialize(init_method=f"file://{tmp_path}/rdv",
                             world_size=2, rank=0, backend="nccl")
    assert not torch.distributed.is_initialized()


def test_more_local_ranks_than_cards_raises(cards, monkeypatch, tmp_path):
    """torchrun's 8 local ranks on a host of 4 cards would pile onto one
    card and leave three idle: refused, naming the card count."""
    cards(4)
    monkeypatch.setenv("LOCAL_RANK", "5")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    with pytest.raises(ValueError, match="8 local ranks on a host of 4"):
        multihost.initialize(init_method=f"file://{tmp_path}/rdv",
                             world_size=8, rank=5)
    assert not torch.distributed.is_initialized()
    assert multihost.default_device(0, 2) == torch.device("cuda", 0)
    cards(1)
    assert multihost.default_device(1, 2) == torch.device("cuda", 0)


def _jax_mesh(world: int, name: str):
    _, _, mesh_kw, _ = render_cases(world)[name]
    devices = jax.devices()[:world]
    return jax_make_mesh(dp=mesh_kw["dp"], geom=mesh_kw.get("geom", 1),
                         devices=devices)


@pytest.mark.parametrize("world,name", [(2, "dp_fast"), (2, "dp_reference"),
                                        (2, "ring_fast"),
                                        (4, "dp_ring_reference")])
def test_matches_jax_render_sharded(ranks, world, name):
    scene, cfg, _, geom_axis = render_cases(world)[name]
    w = scene.meta.width
    ref = jax_arrays.pack_scene(to_jax_desc(cornell_box_scene(w, w)),
                                pad_to=32)
    # the JAX CLI's rule: reference mode runs on the XLA sweeps
    jcfg = JaxConfig(mode=cfg.mode, n_samples=cfg.n_samples,
                     n_bounces=cfg.n_bounces,
                     n_light_samples=cfg.n_light_samples,
                     batch_samples=cfg.batch_samples, accel="none",
                     sort_rays="off",
                     backend="pallas" if cfg.mode == "fast" else "xla")
    want = np.asarray(jax_sharded(ref, jcfg, _jax_mesh(world, name), seed=3,
                                  geom_axis=geom_axis))
    got = ranks[world][0][name]
    close = np.isclose(got, want, rtol=JAX_RTOL, atol=JAX_ATOL).all(axis=-1)
    assert close.mean() >= MIN_CLOSE, (close.mean(),
                                       np.abs(got - want).max())
