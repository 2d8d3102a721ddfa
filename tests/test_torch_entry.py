"""The port's entry points (``pathtracerpython_tpu_torch/entry.py``, in the
style of the JAX package's ``__graft_entry__.py``) on the CPU: ``entry()``
gives a forward render step and example arguments that run, on the
in-repo stand-in when no Cornell SDL is named, and agree with
``render``; ``dryrun_multichip(2)`` starts two gloo ranks itself and runs
the JAX dry run's shapes (the sharded training step on dp x geom, the soft
render on dp, the pipeline bit-equal to one rank); ``dryrun_multichip(4)``
adds the reference render on geom = 4."""

import dataclasses

import pytest
import torch

from pathtracerpython_tpu_torch import entry as entry_mod
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import render
from pathtracerpython_tpu_torch.scene import synthetic


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_entry_runs_the_forward_step_on_the_stand_in(monkeypatch):
    monkeypatch.delenv(entry_mod.SDL_ENV, raising=False)
    said = []
    fn, args = entry_mod.entry(device="cpu", log=said.append)
    assert any("stand-in" in s for s in said)
    scene, origins, dirs, pixel_ids, key = args
    n = scene.meta.width * scene.meta.height
    assert origins.shape == dirs.shape == (n, 3) and pixel_ids.shape == (n,)
    with torch.no_grad():
        rad = fn(*args)
        want = render(scene, RenderConfig(mode="fast", n_samples=1,
                                          n_bounces=4), seed=0)
    assert rad.shape == (n, 3) and torch.isfinite(rad).all()
    assert torch.equal(rad, want)


def test_entry_reads_a_named_sdl(tmp_path, monkeypatch):
    sdl = synthetic.write_sdl(synthetic.cornell_box_scene(6, 6),
                              str(tmp_path))
    monkeypatch.setenv(entry_mod.SDL_ENV, sdl)
    said = []
    fn, args = entry_mod.entry(device="cpu", log=said.append)
    assert said == [f"entry: scene {sdl}"]
    assert args[0].meta.width == 6
    with torch.no_grad():
        assert torch.isfinite(fn(*args)).all()


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_spawns_its_ranks(n, capsys):
    lines = []
    entry_mod.dryrun_multichip(n, platform="cpu", log=lines.append)
    text = "\n".join(lines)
    assert "backend gloo" in text
    assert f"mesh={{'dp': {n // 2}, 'geom': 2}} loss=" in text
    assert "soft-estimator render ok" in text
    assert "pp-pipeline render bit-matches single" in text
    assert ("reference-mode render ok" in text) == (n == 4)


def test_dryrun_of_one_rank_runs_in_process():
    lines = []
    entry_mod.dryrun_multichip(1, platform="cpu", log=lines.append)
    assert any("mesh={'dp': 1, 'geom': 1} loss=" in s for s in lines)


def test_dryrun_size_shrinks_the_scene():
    scene = entry_mod._cornell(None, entry_mod.DRYRUN_SIZE, "cpu",
                               lambda *a: None)
    assert dataclasses.astuple(scene.meta)[:2] == (8, 8)
