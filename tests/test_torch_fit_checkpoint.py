"""Checkpointed fits on the CPU: ``diff.fit(checkpoint_dir=,
checkpoint_every=)`` and ``apps.fit_albedo --checkpoint-every``, stopped
and resumed, give the uninterrupted run's params bit for bit (the CPU's
scatters sum in one order; on the card float atomics do not, so
``chip_smoke.py`` holds the resumed fit to its loss curve there)."""

import json
import os

import pytest
import torch

from pathtracerpython_tpu_torch.apps import fit_albedo
from pathtracerpython_tpu_torch.diff import adam, fit
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import render
from pathtracerpython_tpu_torch.scene import arrays, synthetic
from pathtracerpython_tpu_torch.utils import CheckpointManager


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the time of a test alone and
    leaves the other test workers their cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _problem():
    scene = arrays.pack_scene(synthetic.cornell_box_scene(8, 8), pad_to=32,
                              device="cpu")
    cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=2)
    with torch.no_grad():
        target = render(scene, cfg, seed=0)
    params = {"mat_rgb": scene.mat_rgb * 0.25,
              "light_color": scene.light_color * 2.0,
              "tri_v0": scene.tri_v0}
    return scene, cfg, target, params


def test_resumed_fit_bit_matches_uninterrupted(tmp_path):
    scene, cfg, target, params = _problem()
    run = dict(optimizer=adam(0.05), base_scene=scene, cfg=cfg,
               target=target, seed=4, checkpoint_every=2)
    full, full_losses = fit(params, steps=6,
                            checkpoint_dir=str(tmp_path / "full"), **run)
    plain, plain_losses = fit(params, steps=6, **run)
    # stopped after step 4, then resumed: only steps 5 and 6 run again
    part = str(tmp_path / "part")
    _, first = fit(params, steps=4, checkpoint_dir=part, **run)
    resumed, rest = fit(params, steps=6, checkpoint_dir=part, **run)
    assert len(first) == 4 and len(rest) == 2
    assert first + rest == full_losses == plain_losses
    for k in params:
        assert torch.equal(resumed[k], full[k]), k
        assert torch.equal(plain[k], full[k]), k
    mgr = CheckpointManager(part)
    assert mgr.latest_step() == 6
    state = mgr.restore(6)
    assert set(state) == {"params", "opt_state", "key", "identity"}
    assert torch.equal(state["params"]["mat_rgb"], full["mat_rgb"])
    assert state["opt_state"]["state"][0]["step"] == 6
    # a finished fit resumes at its end and runs nothing
    again, none = fit(params, steps=6, checkpoint_dir=part, **run)
    assert none == [] and torch.equal(again["tri_v0"], full["tri_v0"])


@pytest.mark.parametrize("change", ["lr", "seed", "params", "target",
                                    "past_steps"])
def test_resume_refuses_another_fits_checkpoint(tmp_path, change):
    """A checkpoint directory holding another fit's state (another rate,
    seed, starting params or target), or a step past ``steps``, makes the
    fit refuse, not continue or skip that fit silently."""
    scene, cfg, target, params = _problem()
    ckpt = str(tmp_path / "ckpt")
    run = dict(optimizer=adam(0.05), base_scene=scene, cfg=cfg,
               target=target, seed=4, checkpoint_every=2, steps=2,
               checkpoint_dir=ckpt)
    fit(params, **run)
    other = {"lr": dict(optimizer=adam(0.01)), "seed": dict(seed=5),
             "target": dict(target=target * 0.5), "past_steps": dict(steps=1),
             "params": {}}[change]
    args = {**run, **other}
    start = dict(params)
    if change == "params":
        start["mat_rgb"] = params["mat_rgb"] * 2.0
    with pytest.raises(ValueError, match="past steps" if change ==
                       "past_steps" else "another fit"):
        fit(start, **args)
    # the same fit resumes at its end and runs nothing
    _, none = fit(params, **run)
    assert none == []


def test_fit_albedo_checkpoint_every_resumes_bit_for_bit(tmp_path):
    sdl = synthetic.write_sdl(synthetic.cornell_box_scene(8, 8),
                              str(tmp_path / "scene"))

    def run(out: str, steps: int) -> dict:
        fit_albedo.main(["--scene", sdl, "--steps", str(steps), "--out",
                         str(tmp_path / out), "--checkpoint-every", "2",
                         "--device", "cpu"])
        with open(tmp_path / out / "result.json") as f:
            return json.load(f)

    full = run("full", 4)
    first = run("part", 2)
    rest = run("part", 4)
    assert len(first["losses"]) == 2 and len(rest["losses"]) == 2
    assert first["losses"] + rest["losses"] == full["losses"]
    assert full["loss_last"] < full["loss_first"]

    def final(out: str) -> dict:
        return CheckpointManager(os.path.join(tmp_path, out, "ckpt")
                                 ).restore(4)["params"]

    for k, v in final("full").items():
        assert torch.equal(final("part")[k], v), k
