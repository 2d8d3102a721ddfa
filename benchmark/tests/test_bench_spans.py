"""The readers of the system's own spans and counters: their arithmetic on a
stubbed report, None on a miscount or where the system keeps no report,
and every one of them read from a tiny cell's traced units on the CPU."""

from __future__ import annotations

import pytest

from benchmark import harness
from benchmark.tests.conftest import tiny_cell

SPAN_READERS = {"rng_ms.render": ("ptt.rng", "ptt.chunk"),
                "nearest_ms.render": ("ptt.nearest", "ptt.chunk"),
                "nee_ms.render": ("ptt.nee", "ptt.chunk"),
                "sort_ms.render": ("ptt.sort", "ptt.chunk"),
                "rng_ms.fit": ("ptt.rng", "ptt.step")}


def _span(count, self_s):
    return {"count": count, "host_s": 1.0, "device_s": 2 * self_s,
            "device_self_s": self_s}


def _report(units=3):
    spans = {name: _span(units * 8, 0.06 * (i + 1))
             for i, name in enumerate(("ptt.rng", "ptt.nearest", "ptt.nee",
                                       "ptt.sort"))}
    spans["ptt.chunk"] = spans["ptt.step"] = _span(units, 0.9)
    return {"spans": spans, "counters": {"lane_bounces": 4000,
                                         "live_lane_bounces": 2500}}


@pytest.fixture
def stub(monkeypatch):
    from pathtracerpython_tpu_torch.utils import metrics

    box = {"report": _report()}
    monkeypatch.setattr(metrics, "report", lambda: box["report"])
    return box


def test_readers_on_a_stubbed_report(stub):
    summary = {"units": 3}
    for name, (span, _) in SPAN_READERS.items():
        want = stub["report"]["spans"][span]["device_self_s"] / 3 * 1e3
        assert harness.metric_reader(name)(summary) == pytest.approx(want)
    assert harness.metric_reader("dead_lane_share.render")(
        summary) == pytest.approx(37.5)


@pytest.mark.parametrize("name", [*SPAN_READERS, "dead_lane_share.render"])
def test_none_on_a_unit_count_mismatch(stub, name):
    assert harness.metric_reader(name)({"units": 2}) is None
    stub["report"] = {"spans": {}, "counters": {}}
    assert harness.metric_reader(name)({"units": 3}) is None


def test_none_where_the_system_keeps_no_report(monkeypatch):
    from pathtracerpython_tpu_torch.utils import metrics

    monkeypatch.delattr(metrics, "report")
    for name in (*SPAN_READERS, "dead_lane_share.render"):
        assert harness.metric_reader(name)({"units": 3}) is None


@pytest.mark.parametrize("name", ["cornell.render", "boxfield100k.render",
                                  "cornell.fit"])
def test_read_from_a_tiny_cells_traced_units(name):
    """The cell's driver traces its units under the profiler after a
    window; every span reader of the cell finds its unit count there."""
    wl, config, traffic = tiny_cell(name, size=8, boxes=40, image_spp=16)
    run = harness.driver(traffic["driver"]).Run(wl, config, traffic, 2**33,
                                                device="cpu")
    run.setup()
    run.window(0.01)
    traced = run.traced()
    summary = {"units": traced["units"]}
    bench = harness.benchmark()
    names = [m["name"] for m in harness.cell_metrics(bench, name,
                                                      "per_layer")
             if m["source"] in ("program_span", "program_counter")]
    assert names
    for m in names:
        value = harness.metric_reader(m)(summary)
        assert value is not None and value >= 0.0, m
