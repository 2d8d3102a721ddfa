"""The plain reference against the system's CPU path at a tiny size: the
random stream word for word, and each cell's check on a sound run."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness, reference
from benchmark.tests.conftest import tiny_cell


def test_threefry_stream_and_chunk_seeds_match_the_system():
    from pathtracerpython_tpu_torch.ops import rng
    from pathtracerpython_tpu_torch.utils.checkpoint import chunk_seed

    for seed in (0, 7, 2**31 + 5, 2**40 + 3):
        for chunk in (0, 1, 15):
            assert reference.chunk_seed(seed, chunk) == chunk_seed(seed,
                                                                   chunk)
        key = reference.key_of(seed)
        assert key == rng.key_from_seed(seed)
        assert list(reference.split(key)) == rng.split(key)
        assert reference.derive(key, 9) == rng.fold(*key, 9)
    counters = torch.arange(0, 5000, 7, dtype=torch.int64) * 977
    got = reference.uniforms((11, 12), counters, 15, torch.float32)
    assert torch.equal(got, rng.uniforms(11, 12, counters, 15))


def _sound(name, **kw):
    wl, config, traffic = tiny_cell(name, **kw)
    run = harness.driver(traffic["driver"]).Run(wl, config, traffic,
                                                2**31 + 17, "cpu")
    run.setup()
    run.window(0.05)
    run.release()
    return run.check({"radiance_rel_l1": 1.0, "loss1_gap": 1.0,
                      "grad_gap": 1.0, "change_gap": 1.0}, "cpu")


@pytest.mark.parametrize("name", ["cornell.render",
                                  "cornell.render.reference"])
def test_cornell_renders_agree(name):
    (check,) = _sound(name, size=10, image_spp=16)
    assert check[0] == "radiance_rel_l1" and check[1] < 1e-5


def test_box_field_hybrid_agrees():
    from pathtracerpython_tpu_torch.kernels.sparse import SPARSE_MIN_TRIS

    # 12 * 400 + 4 triangles: past SPARSE_MIN_TRIS, so the hybrid runs
    assert 12 * 400 + 4 >= SPARSE_MIN_TRIS
    (check,) = _sound("boxfield100k.render", size=6, boxes=400,
                      image_spp=16)
    assert check[1] < 1e-5


def test_fit_first_steps_agree():
    checks = dict((n, v) for n, v, _ in _sound("cornell.fit", size=8))
    assert checks["loss1_gap"] < 1e-5
    assert checks["grad_gap"] < 1e-4
    assert checks["change_gap"] < 0.05
