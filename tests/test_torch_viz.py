"""The port's debug view (``viz/plot.py``, a copy of the JAX package's for
``SceneTensors``): ``plot_scene`` writes a PNG with every overlay, and
says what is missing when matplotlib is not installed."""

import builtins

import numpy as np
import pytest
import torch
from PIL import Image

from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.ops.geometry import nearest_hit
from pathtracerpython_tpu_torch.scene import arrays, synthetic
from pathtracerpython_tpu_torch.viz import plot


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: with one intra-op thread these tests take
    the same time alone and do not fight the other test workers for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def cornell():
    return arrays.pack_scene(synthetic.cornell_box_scene(6, 6), pad_to=32,
                             device="cpu")


def test_plot_scene_writes_a_png(cornell, tmp_path):
    o, d = make_primary_rays(cornell.eye, cornell.ortho, 6, 6)
    hit = nearest_hit(o, d, cornell, mode="reference")
    out = plot.plot_scene(
        cornell, str(tmp_path / "view.png"), show_normals=True,
        show_screen=True, screen_colors=torch.rand(36, 3),
        intersections=hit.point[hit.hit], rays=(o[:4], d[:4]))
    img = np.asarray(Image.open(out))
    assert img.ndim == 3 and img.shape[0] > 100 and img.std() > 0


def test_missing_matplotlib_is_named(cornell, tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_matplotlib(name, *args, **kwargs):
        if name.startswith("matplotlib"):
            raise ImportError("No module named 'matplotlib'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_matplotlib)
    with pytest.raises(ImportError, match="need matplotlib"):
        plot.plot_scene(cornell, str(tmp_path / "x.png"))
