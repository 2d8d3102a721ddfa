"""The schema of a run's last line."""

from __future__ import annotations

import json
import math

from benchmark import harness


def test_result_line_schema():
    checks = [("radiance_rel_l1", 1e-5, 1e-3)]
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
              "memory_peak_bytes": 123, "power_limit_w": 700.0,
              "busy_s": 0.5, "window_s": 1.0}
    line = harness.result_line(True, 10, 0, {"paths_per_s": {
        "value": 30.5, "unit": "Mpaths/s"}}, device, checks,
        {"device_ops": [["k", 0.1]], "idle_gaps": [["op", 0.2]]})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["checks"] == {"radiance_rel_l1": {"value": 1e-5,
                                                 "limit": 1e-3}}
    assert out["metrics"]["paths_per_s"]["unit"] == "Mpaths/s"
    plain = json.loads(harness.result_line(False, 1, 1, {}, device, checks))
    assert list(plain)[-1] == "checks" and "breakdown" not in plain


def test_correct_needs_every_number_finite_and_within_its_limit():
    assert harness.is_correct([("a", 0.1, 0.2), ("b", 0.0, 0.0)])
    assert not harness.is_correct([("a", 0.3, 0.2)])
    assert not harness.is_correct([("a", math.nan, 0.2)])
    assert not harness.is_correct([("a", math.inf, 0.2)])
    assert not harness.is_correct([])


def test_check_lines_name_each_number_and_its_limit():
    assert harness.check_lines([("loss1_gap", 0.5, 0.25)]) == [
        "check loss1_gap 0.5 limit 0.25"]


def test_a_number_that_is_not_finite_prints_as_null():
    line = harness.result_line(False, 0, 0, {}, {}, [("a", math.inf, 1.0)])
    assert json.loads(line)["checks"]["a"] == {"value": None, "limit": 1.0}
