"""The check fails what it must: its control (the reference computed in
bfloat16 and put in the system's place) on every cell, and a run driven
through the harness with the timed path broken underneath, once for each
fault the cell can have. A sound run beside them passes. At a tiny size on
the CPU, with the cells' own limits."""

from __future__ import annotations

import pytest
import torch

from benchmark import harness
from benchmark.drivers import fit, progressive
from benchmark.tests.conftest import tiny_cell

SEED = 2**31 + 101
RENDER_CELLS = ["cornell.render", "boxfield100k.render",
                "cornell.render.reference"]


def _tiny(name):
    if name.startswith("boxfield100k"):
        return tiny_cell(name, size=8, boxes=40, image_spp=16)
    return tiny_cell(name, size=10, image_spp=16)


@pytest.mark.parametrize("name", RENDER_CELLS)
def test_render_control_fails(name):
    wl, config, traffic = _tiny(name)
    (row,) = progressive.readings(wl, config, traffic, [SEED], "control",
                                  "cpu")
    assert row["radiance_rel_l1"] > harness.limits(name)["radiance_rel_l1"]


def test_fit_control_fails():
    wl, config, traffic = tiny_cell("cornell.fit", size=8)
    (row,) = fit.readings(wl, config, traffic, [SEED], "control", "cpu")
    lim = harness.limits("cornell.fit")
    assert any(row[k] > lim[k] for k in lim)


def _run(name, patch=None):
    """A run's correct bit, driven through setup, window, release and
    check, with ``patch()`` applied underneath the timed path."""
    wl, config, traffic = _tiny(name)
    run = harness.driver(traffic["driver"]).Run(wl, config, traffic, SEED,
                                                "cpu")
    with pytest.MonkeyPatch.context() as mp:
        if patch is not None:
            patch(mp)
        run.setup()
        run.window(0.05)
        run.release()
    return harness.is_correct(run.check(harness.limits(name), "cpu"))


def _wrap_render(mp, change):
    from pathtracerpython_tpu_torch.render import integrator

    render = integrator.render
    mp.setattr(integrator, "render",
               lambda scene, cfg, seed=0: change(render, scene, cfg, seed))


def alter_answer(mp):
    """Every chunk's radiance 5% too bright where it is produced."""
    _wrap_render(mp, lambda r, sc, cfg, seed: r(sc, cfg, seed) * 1.05)


def half_batch(mp):
    """Half of each chunk's samples left out, the mean over the rest."""
    import dataclasses

    _wrap_render(mp, lambda r, sc, cfg, seed: r(
        sc, dataclasses.replace(cfg, n_samples=cfg.n_samples // 2), seed))


@pytest.mark.parametrize("name", RENDER_CELLS)
@pytest.mark.parametrize("fault", [None, alter_answer, half_batch])
def test_render_faults_are_caught(name, fault):
    assert _run(name, fault) is (fault is None)


def state_unchanged(mp):
    """The optimizer's step returns the parameters unchanged."""
    mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def fit_half_batch(mp):
    from pathtracerpython_tpu_torch.diff import inverse

    mp.setattr(inverse, "camera_pixel_loss", fit._half_batch_loss)


def fit_alter_answer(mp):
    """Every step's loss 5% too high where it is produced."""
    from pathtracerpython_tpu_torch.diff import inverse

    loss = inverse.camera_pixel_loss
    mp.setattr(inverse, "camera_pixel_loss",
               lambda *a, **k: loss(*a, **k) * 1.05)


@pytest.mark.parametrize("fault", [None, state_unchanged, fit_half_batch,
                                   fit_alter_answer])
def test_fit_faults_are_caught(fault):
    assert _run("cornell.fit", fault) is (fault is None)
