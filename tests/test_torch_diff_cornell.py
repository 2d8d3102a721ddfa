"""The port's loss and gradients against the JAX package's on the Cornell
stand-in ``cornell_box_scene(16, 16)``: every scene field (and, through
``camera_pixel_loss``, the camera) through ``pixel_loss`` and
``camera_pixel_loss``, with the fused NEE (K2 under ``NeeMeanCos``), the
unfused NEE with 9 samples (K4 detached) and the Plücker form (K3's dense
nearest under ``NearestTIdx``). The JAX package runs ``backend="pallas"``
in interpret mode. Tolerances: torch_diff_parity.py's (loss 1e-6
relative, gradients 1e-4 relative L2 per field)."""

import pytest
import torch

from pathtracerpython_tpu_torch.scene import synthetic
from torch_diff_parity import run_case
from torch_parity import pack_pair

BASE = dict(n_samples=1, n_bounces=2)
CASES = {
    "fused": (dict(n_light_samples=3), "classic"),
    "unfused9": (dict(n_light_samples=9), "classic"),
    "plucker": (dict(n_light_samples=3), "plucker"),
}


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
    return pack_pair(synthetic.cornell_box_scene(16, 16), pad_to=32)


@pytest.mark.parametrize("loss", ["camera", "pixel"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cornell_loss_and_grads_match_jax(cornell, case, loss):
    cfg_kw, mt_impl = CASES[case]
    worst = run_case(*cornell, {**BASE, **cfg_kw}, loss == "camera",
                     mt_impl)
    print(f"{case} {loss}: worst relative L2 {worst:.3g}")
