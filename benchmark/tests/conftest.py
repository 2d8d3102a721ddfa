"""Shared helpers of the benchmark's CPU tests: cells cut to a size a test
run holds, and the card fixture."""

from __future__ import annotations

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def tiny_cell(name: str, size: int = 12, boxes: int = 40,
              image_spp: int = 32):
    """(workload, configuration, traffic) of a cell at a tiny size: the
    image ``size`` square, ``boxes`` boxes in a box field, ``image_spp``
    samples an image and one traced unit."""
    wl, config, traffic = harness.cell(name)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    config["scene"]["width"] = config["scene"]["height"] = size
    if config["scene"]["kind"] == "box_field":
        config["scene"]["n_boxes"] = boxes
    config["render"]["image_spp"] = image_spp
    traffic.setdefault("render", {}).pop("image_spp", None)
    traffic["trace_units"] = 1
    config["check"]["pixels"] = min(config["check"]["pixels"], 64)
    return wl, config, traffic


@pytest.fixture
def card():
    """Skips the test unless a CUDA device is present."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return "cuda"
