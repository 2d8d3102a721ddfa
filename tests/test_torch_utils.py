"""The port's ``utils/``: the checkpoint manager, the chunk seeds of
``render_progressive`` against JAX's ``fold_in`` / ``randint``, a resumed
progressive render against an uninterrupted one, the port's progressive
render against the JAX package's, and the metrics and profiling hooks.

Tolerances: checkpoints, seeds and resumed renders are exact (bits); the
port's render against JAX's holds rtol = atol = 1e-4 on 99% of pixels, the
rule of ``test_torch_render.py`` (XLA:CPU's rsqrt, sin and cos round
differently in the last bit)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.render.config import RenderConfig as JaxConfig
from pathtracerpython_tpu.utils.checkpoint import (
    render_progressive as jax_render_progressive,
)
from pathtracerpython_tpu_torch.ops import rng
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.scene import synthetic
from pathtracerpython_tpu_torch.utils import (
    CheckpointManager,
    MetricsLogger,
    render_progressive,
    trace_context,
)
from pathtracerpython_tpu_torch.utils.checkpoint import chunk_seed
from torch_parity import pack_pair

SEEDS = (0, 1, 9, 123, 2**31 - 1)
CHUNKS = range(21)
quiet = lambda *a: None  # noqa: E731


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the time of a test alone and
    leaves the other test workers their cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cornell():
    return pack_pair(synthetic.cornell_box_scene(12, 12))


def test_checkpoint_roundtrip(tmp_path):
    state = {"a": torch.arange(12.0).reshape(3, 4), "n": 7,
             "opt": {"state": {0: {"step": torch.tensor(3.0)}},
                     "groups": [{"lr": 0.05, "betas": (0.9, 0.999)}]},
             "key": (1, 2**32 - 1)}
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step() is None
    mgr.save(3, state)
    mgr.save(12, {**state, "n": 8})
    (tmp_path / "ck" / "step_00000099.tmp").mkdir()  # a stopped save
    assert mgr.latest_step() == 12
    assert sorted(os.listdir(tmp_path / "ck"))[:2] == ["step_00000003",
                                                       "step_00000012"]
    back = mgr.restore(3)
    assert torch.equal(back["a"], state["a"]) and back["n"] == 7
    assert back["opt"]["groups"][0]["betas"] == (0.9, 0.999)
    assert tuple(back["key"]) == (1, 2**32 - 1)
    mgr.save(3, {**state, "n": 9})  # replaces the step
    assert mgr.restore(3)["n"] == 9
    # a template moves tensors to its tensors' devices and float dtypes
    like = mgr.restore(3, {"a": torch.zeros(1, dtype=torch.float64)})
    assert like["a"].dtype == torch.float64


def test_chunk_seeds_match_jax_table():
    """``chunk_seed`` is ``randint(fold_in(PRNGKey(seed), chunk), (), 0,
    2^31 - 1)`` of JAX (0.9, partitionable threefry), word for word."""
    assert jax.config.jax_threefry_partitionable
    for seed in SEEDS:
        for chunk in CHUNKS:
            key = jax.random.fold_in(jax.random.PRNGKey(seed), chunk)
            assert rng.fold_in(seed, chunk) == tuple(
                int(w) for w in jax.random.key_data(key))
            want = int(jax.random.randint(key, (), 0,
                                          np.iinfo(np.int32).max))
            assert chunk_seed(seed, chunk) == want, (seed, chunk)


@pytest.mark.parametrize("bounds", [(0, 10), (-5, 7), (3, 3), (7, 2),
                                    (-2**31, 2**31 - 1), (10, 2**20)])
def test_randint_matches_jax(bounds):
    for seed in (0, 42, 2**31 - 1):
        want = int(jax.random.randint(jax.random.PRNGKey(seed), (),
                                      *bounds))
        assert rng.randint(seed, *bounds) == want


def test_resumed_render_bit_matches_uninterrupted(cornell, tmp_path):
    scene, _ = cornell
    cfg = RenderConfig(mode="fast", n_bounces=2)
    full = render_progressive(scene, cfg, 8, 2, str(tmp_path / "full"),
                              seed=5, log=quiet)
    # stop after chunk 2 of 4, then resume in a fresh call
    part = str(tmp_path / "part")
    render_progressive(scene, cfg, 4, 2, part, seed=5, log=quiet)
    lines = []
    resumed = render_progressive(scene, cfg, 8, 2, part, seed=5,
                                 log=lines.append)
    assert lines[0] == "resumed at chunk 2/4"
    assert torch.equal(resumed, full)
    unchecked = render_progressive(scene, cfg, 8, 2, None, seed=5, log=quiet)
    assert torch.equal(unchecked, full)
    assert CheckpointManager(part).latest_step() == 4


def test_progress_callback_and_ragged_last_chunk(cornell):
    scene, _ = cornell
    calls = []
    out = render_progressive(
        scene, RenderConfig(mode="reference"), 5, 2, None, seed=1,
        log=quiet, progress=lambda *a: calls.append(a))
    assert [c[:3] for c in calls] == [(1, 3, 2), (2, 3, 4), (3, 3, 6)]
    assert all(c[3] > 0 for c in calls)
    assert out.shape == (144, 3)


@pytest.mark.parametrize("mode", ["reference", "fast"])
def test_progressive_render_matches_jax(cornell, mode):
    """The same chunk seeds, so the same image as JAX's chunked render."""
    scene, ref = cornell
    got = render_progressive(scene, RenderConfig(mode=mode, n_bounces=2),
                             4, 2, None, seed=11, log=quiet).numpy()
    want = np.asarray(jax_render_progressive(
        ref, JaxConfig(mode=mode, n_bounces=2, backend="pallas",
                       accel="none"), 4, 2, None, seed=11, log=quiet))
    close = np.isclose(got, want, rtol=1e-4, atol=1e-4).all(axis=-1)
    assert close.mean() >= 0.99, (close.mean(), np.abs(got - want).max())


def test_metrics_logger(capsys):
    m = MetricsLogger()
    with m.timed("phase_a") as box:
        box["out"] = torch.ones((8, 8)) * 2
    with m.timed("phase_a", device="cpu"):
        pass
    m.count("rays", 64)
    m.count("rays", 64)
    s = m.summary()
    assert s["calls"]["phase_a"] == 2 and s["counters"]["rays"] == 128
    assert s["timings_s"]["phase_a"] > 0
    assert m.rate("rays", "phase_a") > 0 and m.rate("rays", "none") == 0.0
    m.log()
    assert json.loads(capsys.readouterr().out)["calls"] == {"phase_a": 2}


def test_trace_context_writes_a_trace(tmp_path):
    with trace_context(str(tmp_path / "tr")) as prof:
        torch.ones(64).mul(2).sum()
        rng.uniforms(1, 2, torch.arange(8), 3)
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    assert any("mul" in e.key for e in prof.key_averages())
    spans = json.loads((tmp_path / "tr" / "spans.json").read_text())
    assert list(spans["spans"]) == ["ptt.rng"]
    assert spans["spans"]["ptt.rng"]["count"] == 1
    assert spans["spans"]["ptt.rng"]["device_s"] > 0
    assert spans["counters"] == {}
