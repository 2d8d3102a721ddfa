"""On the card: a short run of each cell prints a correct result line."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.benchmark()["workloads"]])
def test_short_run_is_correct(card, name):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", name,
         "--seed", str(2**31 + 7), "--seconds", "10", "--trace", "0"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
