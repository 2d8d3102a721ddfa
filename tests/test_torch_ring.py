"""The port's geometry ring (``parallel/ring.py``) on gloo ranks on the CPU
against the dense sweeps of one process: the nearest hit, the shadow
any-hit and the first occluder, with GLOBAL rows, at 2 and 4 shards, in
fast mode (K1 and K4's plain versions on each shard) and reference mode
(the row-major reference sweeps).

Two scenes: a 24-box field (290 triangles in 320 rows, so shards of 160
and 80 rows) and the Cornell stand-in's buffer repeated once per shard,
whose every row has an exact twin in every shard: every hit ties across
the ring, and the lowest global row must win, as the dense sweep's first
minimum does, whatever order the shards arrive in.

Tolerance: none. A shard's sweep computes each pair as the whole buffer's
does, so winners, t, normals, materials, points and bits are equal."""

import numpy as np
import pytest
import torch

from pathtracerpython_tpu_torch.ops.geometry import (
    any_hit_within_cm,
    first_occluder_index,
    nearest_hit_cm,
    normalize3,
)
from torch_parallel_worker import ring_rays, ring_scenes, spawn_ranks

WORLDS = (2, 4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world -> every rank's arrays of the ring suite."""
    return {w: spawn_ranks("ring", w, str(tmp_path_factory.mktemp(f"r{w}")))
            for w in WORLDS}


def _dense(world: int, name: str, mode: str):
    scene = ring_scenes(world)[name]
    o, d, maxd = ring_rays(scene, 300, seed=5)
    o3, d3 = o.T.contiguous(), d.T.contiguous()
    with torch.no_grad():
        hit = nearest_hit_cm(o3, d3, scene, mode=mode)
        occ = any_hit_within_cm(o3, normalize3(d3), maxd, scene, mode=mode)
        first = first_occluder_index(o, d, maxd, scene)
    return scene, hit, occ, first


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_gets_the_same_records(ranks, world):
    first = ranks[world][0]
    for other in ranks[world][1:]:
        assert sorted(other) == sorted(first)
        for k in first:
            np.testing.assert_array_equal(other[k], first[k], err_msg=k)


@pytest.mark.parametrize("mode", ["fast", "reference"])
@pytest.mark.parametrize("name", ["field", "tie"])
@pytest.mark.parametrize("world", WORLDS)
def test_ring_nearest_equals_dense(ranks, world, name, mode):
    got = ranks[world][0]
    _, hit, _, _ = _dense(world, name, mode)
    key = f"{name}_{mode}_"
    hits = hit.hit.numpy()
    assert hits.sum() > 50
    np.testing.assert_array_equal(got[key + "hit"], hits)
    np.testing.assert_array_equal(got[key + "tri_idx"], hit.tri_idx.numpy())
    np.testing.assert_array_equal(got[key + "t"], hit.t.numpy())
    for f in ("material", "is_light"):
        np.testing.assert_array_equal(got[key + f][hits],
                                      getattr(hit, f).numpy()[hits])
    for f in ("point3", "normal3"):
        np.testing.assert_array_equal(got[key + f][:, hits],
                                      getattr(hit, f).numpy()[:, hits])


@pytest.mark.parametrize("world", WORLDS)
def test_exact_ties_go_to_the_lowest_global_row(ranks, world):
    """On the repeated buffer every winner lies in the first copy (shard 0's
    rows), in both modes: shards that arrive later with an equal key lose."""
    scene = ring_scenes(world)["tie"]
    per = scene.num_padded_triangles // world
    for mode in ("fast", "reference"):
        got = ranks[world][0]
        hits = got[f"tie_{mode}_hit"]
        assert hits.sum() > 50
        assert (got[f"tie_{mode}_tri_idx"][hits] < per).all(), mode


@pytest.mark.parametrize("mode", ["fast", "reference"])
@pytest.mark.parametrize("name", ["field", "tie"])
@pytest.mark.parametrize("world", WORLDS)
def test_ring_any_hit_equals_dense(ranks, world, name, mode):
    _, _, occ, _ = _dense(world, name, mode)
    assert 0 < int(occ.sum()) < occ.numel()
    np.testing.assert_array_equal(ranks[world][0][f"{name}_{mode}_occ"],
                                  occ.numpy())


@pytest.mark.parametrize("name", ["field", "tie"])
@pytest.mark.parametrize("world", WORLDS)
def test_ring_first_occluder_equals_dense(ranks, world, name):
    _, _, _, (idx, mat) = _dense(world, name, "reference")
    assert (idx >= 0).sum() > 20
    np.testing.assert_array_equal(ranks[world][0][f"{name}_first_idx"],
                                  idx.numpy())
    np.testing.assert_array_equal(ranks[world][0][f"{name}_first_mat"],
                                  mat.numpy())
