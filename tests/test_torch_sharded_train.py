"""The port's sharded training step (``diff.make_train_step(mesh=...)``) on
gloo ranks on the CPU against the single-process step, as the JAX package's
tests/test_diff.py::test_sharded_train_step_matches_single holds its own:
the flat scene of that test, SGD(0.1) on ``mat_rgb``, Adam(1e-2) on
``mat_rgb``, ``light_color`` and ``eye`` (the JAX dry run's parameters),
and SGD on ``tri_v0`` under pure dp, over dp = 2 and 4, dp x geom = 1 x 2
and 2 x 2, and SGD on ``tri_v0`` under a geometry ring, whose gradient
flows back around the ring (``parallel/ring.py:RingShift``; the ring's
gradients are held more widely in test_torch_ring_grad.py).

Tolerances: tests/test_diff.py's, loss rtol 1e-6, params rtol 1e-5 and
atol 1e-7 (the ranks' gradients are summed in another order than one
process sums its lanes). Against the JAX package's sharded step on its
virtual CPU mesh: loss rtol 1e-6 and params rtol 1e-4 / atol 1e-6 (its
Pallas kernels in interpret mode round rsqrt in the last bit,
tests/torch_diff_parity.py)."""

import jax
import numpy as np
import optax
import pytest
import torch

from pathtracerpython_tpu.diff import make_train_step as jax_train_step
from pathtracerpython_tpu.parallel import make_mesh as jax_make_mesh
from pathtracerpython_tpu.render.config import RenderConfig as JaxConfig
from pathtracerpython_tpu.render.integrator import render as jax_render
from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu_torch.diff import make_train_step
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import render
from pathtracerpython_tpu_torch.scene.synthetic import flat_scene
from torch_parallel_worker import (
    make_optimizer,
    spawn_ranks,
    train_cases,
    train_scene,
    train_start,
)
from torch_parity import to_jax_desc

WORLDS = (2, 4)
CFG = dict(mode="fast", n_samples=1, n_bounces=2)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return {w: spawn_ranks("train", w,
                           str(tmp_path_factory.mktemp(f"train{w}")))
            for w in WORLDS}


def _single_step(kind: str, names):
    scene = train_scene()
    cfg = RenderConfig(**CFG)
    with torch.no_grad():
        target = render(scene, cfg, seed=1)
    params = {k: v.clone().requires_grad_(True)
              for k, v in train_start(scene, names).items()}
    step = make_train_step(make_optimizer(kind, list(params.values())),
                           scene, cfg, target)
    loss = step(params, (0, 5))
    return float(loss), {k: v.detach().numpy() for k, v in params.items()}


CASES = [(w, name) for w in WORLDS for name in train_cases(w)]


@pytest.mark.parametrize("world,name", CASES)
def test_sharded_step_matches_single(ranks, world, name):
    kind, names, _, _ = train_cases(world)[name]
    loss, params = _single_step(kind, names)
    start = train_start(train_scene(), names)
    for rank in ranks[world]:
        np.testing.assert_allclose(float(rank[f"{name}:loss"]), loss,
                                   rtol=1e-6)
        for k, v in params.items():
            np.testing.assert_allclose(rank[f"{name}:{k}"], v, rtol=1e-5,
                                       atol=1e-7, err_msg=k)
            # the step moved the parameter (a gradient arrived)
            assert not np.array_equal(v, start[k].numpy()), k


@pytest.mark.parametrize("world", WORLDS)
def test_triangle_grads_under_a_ring_refuse(ranks, world):
    """Under a ring (dp x geom = 1 x 2, 2 x 2) a ``tri_v0`` step no longer
    refuses: it gives the single step, its gradient included, so it was
    never silently zero."""
    loss, params = _single_step("sgd", ("tri_v0",))
    start = train_start(train_scene(), ("tri_v0",))["tri_v0"].numpy()
    for rank in ranks[world]:
        np.testing.assert_allclose(float(rank["tri_ring:loss"]), loss,
                                   rtol=1e-6)
        np.testing.assert_allclose(rank["tri_ring:tri_v0"], params["tri_v0"],
                                   rtol=1e-5, atol=1e-7)
        grad = rank["tri_ring:grad"]
        assert np.abs(grad).max() > 0
        np.testing.assert_allclose(start - 0.1 * grad, params["tri_v0"],
                                   rtol=1e-5, atol=1e-7)


def test_ring_refuses_before_any_silent_zero():
    """In one process too: a ring of one rank (``make_mesh(device=
    "cpu")``) with triangle tensors that require grad gives the unsharded
    step's params and gradient."""
    from pathtracerpython_tpu_torch.parallel import make_mesh

    scene = train_scene()
    cfg = RenderConfig(**CFG)
    with torch.no_grad():
        target = render(scene, cfg, seed=1)
    got = {}
    for mesh, axis in ((make_mesh(device="cpu"), "geom"), (None, None)):
        params = {k: v.clone().requires_grad_(True)
                  for k, v in train_start(scene, ("tri_v0",)).items()}
        step = make_train_step(torch.optim.SGD(list(params.values()),
                                               lr=0.1),
                               scene, cfg, target, mesh=mesh,
                               geom_axis=axis)
        got[axis] = (float(step(params, (0, 5))), params["tri_v0"])
    assert got["geom"][0] == got[None][0]
    assert torch.equal(got["geom"][1].grad, got[None][1].grad)
    assert got[None][1].grad.abs().max() > 0
    assert torch.equal(got["geom"][1], got[None][1])


def test_sharded_step_matches_jax(ranks):
    """The dp = 1 x geom = 2 SGD step against the JAX package's sharded
    step on the same mesh shape."""
    ref = jax_arrays.pack_scene(to_jax_desc(flat_scene()))
    cfg = JaxConfig(backend="pallas", **CFG)
    target = jax_render(ref, cfg, seed=1)
    opt = optax.sgd(0.1)
    params = {"mat_rgb": ref.mat_rgb * 0.8}
    mesh = jax_make_mesh(dp=1, geom=2, devices=jax.devices()[:2])
    step = jax_train_step(opt, ref, cfg, target, mesh=mesh, geom_axis="geom")
    p, _, loss = step(params, opt.init(params), jax.random.PRNGKey(5))
    got = ranks[2][0]
    np.testing.assert_allclose(float(got["sgd_ring:loss"]), float(loss),
                               rtol=1e-6)
    np.testing.assert_allclose(got["sgd_ring:mat_rgb"],
                               np.asarray(p["mat_rgb"]), rtol=1e-4,
                               atol=1e-6)
