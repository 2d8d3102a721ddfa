"""The harness finds every part of a cell by name, and a new part by
adding files and entries only; BENCHMARK.json keeps to its contract."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_resolves_by_name():
    bench = harness.benchmark()
    for wl in bench["workloads"]:
        _, config, traffic = harness.cell(wl["name"], bench)
        assert config["name"] == wl["config"]
        __import__(f"benchmark.scenes.{config['scene']['kind']}")
        assert hasattr(harness.driver(traffic["driver"]), "Run")
        assert harness.limits(wl["name"])
        e2e = {m["name"] for m in harness.cell_metrics(bench, wl["name"],
                                                        "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.cell_metrics(bench, wl["name"], "per_layer")
        assert layer
        for m in layer:
            assert callable(harness.metric_reader(m["name"]))
            assert m["moves"] in e2e


def test_contract_shape():
    path = os.path.join(harness.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) < 64 * 1024
    bench = harness.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    for p in bench["paths"]:
        assert os.path.isdir(os.path.join(harness.ROOT, p))
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(bench["paths"][0] + "/")
        assert all(NAME.match(k) for k in c["reduced"])
    seen = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
    for m in bench["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert UNIT.match(m["unit"]) and "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


DUMMY_READER = "def read(summary):\n    return 1.0\n"
DUMMY_DRIVER = "class Run:\n    pass\n"


def test_a_new_part_is_found_by_adding_files(tmp_path):
    """A dummy configuration, mix, driver, metric and cell, added as files
    and entries beside the real ones, resolve by name."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark()
    b = root / "benchmark"
    (b / "configs" / "dummy.json").write_text(json.dumps(
        {"name": "dummy", "scene": {"kind": "cornell"}}))
    (b / "traffic" / "dummy.mix.json").write_text(json.dumps(
        {"driver": "dummy"}))
    (b / "drivers" / "dummy.py").write_text(DUMMY_DRIVER)
    (b / "metrics" / "dummy_metric.x.py").write_text(DUMMY_READER)
    (b / "limits" / "dummy.dummy.mix.json").write_text("{}")
    bench["configs"].append({"name": "dummy", "source": "x",
                             "file": "benchmark/configs/dummy.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "dummy.dummy.mix", "config": "dummy",
                               "traffic": "dummy.mix", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "dummy_metric.x", "unit": "ms",
                               "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "setup_s",
                               "workloads": ["dummy.dummy.mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "from benchmark import harness\n"
        "wl, cfg, tr = harness.cell('dummy.dummy.mix')\n"
        "print(cfg['name'], tr['driver'],"
        " harness.driver(tr['driver']).Run.__name__,"
        " [m['name'] for m in harness.cell_metrics(harness.benchmark(),"
        " wl['name'], 'per_layer')],"
        " harness.metric_reader('dummy_metric.x')({}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": str(root)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["dummy", "dummy", "Run",
                                  "['dummy_metric.x']", "1.0"]
