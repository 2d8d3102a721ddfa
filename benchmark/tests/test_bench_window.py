"""The window's arithmetic on synthetic clocks: a rate over every chunk
completed in the window and all its time, a p95 over all steps."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.drivers import fit, progressive


def test_nearest_rank_percentile():
    assert harness.percentile(list(range(1, 101)), 95) == 95
    assert harness.percentile([5.0] * 19 + [50.0], 95) == 5.0
    assert harness.percentile([5.0] * 19 + [50.0, 60.0], 95) == 50.0
    assert harness.percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        harness.percentile([], 95)


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_progressive_rate_counts_every_chunk_to_the_last(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(progressive.time, "perf_counter", clock)
    run = progressive.Run({"name": "x"}, {"render": {
        "image_spp": 64, "chunk_spp": 16, "n_bounces": 2,
        "n_light_samples": 3}}, {}, seed=1, device="cpu")

    class Raw:
        width = height = 4

    run.raw = Raw()

    def fake(scene, cfg, total, chunk, ckpt, seed, log, progress):
        n = total // chunk
        for i in range(n):
            clock.t += 0.3
            progress(i + 1, n, (i + 1) * chunk, 0.3)
        return "image"

    run._render_progressive = fake
    run.scene = run.cfg = None
    metrics, attempted, failed, _ = run.window(1.0)
    # chunks end at 0.3, 0.6, 0.9, 1.2: the fourth closes the window
    assert attempted == 4 and failed == 0
    # the fourth chunk completed the image: it is kept for the check
    assert [img for _, img in run.images] == ["image"]
    assert metrics["paths_per_s"] == pytest.approx(
        4 * 16 * 16 / 1.2 / 1e6)


def test_fit_window_p95_over_all_steps(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(fit.time, "perf_counter", clock)
    run = fit.Run({"name": "x"}, {"render": {}}, {}, seed=1, device="cpu")
    steps = iter([0.01] * 18 + [0.5, 0.6])

    def one():
        import torch

        clock.t += next(steps)
        return torch.tensor(1.0)

    run._one = one
    metrics, attempted, failed, _ = run.window(1.0)
    # the step that ends past the deadline closes the window and counts
    assert attempted == 20 and failed == 0
    assert metrics["step_ms"] == pytest.approx((0.18 + 1.1) / 20 * 1e3)
    # 20 steps: the 19th smallest is the nearest-rank p95
    assert metrics["step_p95_ms"] == pytest.approx(500.0)
