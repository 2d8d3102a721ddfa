"""Triangle gradients around the port's geometry ring
(``parallel/ring.py:RingShift``) on gloo ranks on the CPU, against one
process, at 2 and 4 ranks:

- the nearest sweep's gradient with respect to ``tri_v0/1/2`` (through t,
  the hit point and the normal), fast and reference mode, on the ring
  scenes of tests/test_torch_ring.py, each rank sweeping its share of the
  rays: the ranks' home-shard gradients add up to the single process's;
- a case where rank 0's rays hit nothing: every rank finishes (the ranks
  run under spawn_ranks' timeout) and rank 0's rows still get the other
  ranks' gradients;
- sharded SGD and Adam steps on ``tri_v0``, ``tri_v1`` and ``light_v0`` at
  dp x geom = 1 x 2 and 2 x 2 (and Adam at 1 x 4), in reference mode and
  with ``remat_bounces``, and a two-step ``fit``, against the single
  step and fit;
- the ring's traffic: every rank makes as many reverse shifts as the
  differentiable forward chains made shifts, the any-hit chains send
  nothing backward; ranks whose reverse shifts pair different forward
  shifts raise;
- the 1 x 2 step on ``tri_v0`` against the JAX package's sharded step on
  its CPU mesh (its gradient, read back through an optax transformation
  that keeps it).

Tolerances: tests/test_diff.py's, loss rtol 1e-6, params rtol 1e-5 / atol
1e-7 (after Adam, where the gradient is at least 100 x Adam's eps), and
gradients rtol 1e-5 with an atol of 1e-6 of the largest (the ranks'
gradients are summed in another order than one process's lanes);
against the JAX package the cross-package ones of
test_torch_sharded_train.py, loss rtol 1e-6 and rtol 1e-4 / atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pathtracerpython_tpu.diff import make_train_step as jax_train_step
from pathtracerpython_tpu.parallel import make_mesh as jax_make_mesh
from pathtracerpython_tpu.render.config import RenderConfig as JaxConfig
from pathtracerpython_tpu.render.integrator import render as jax_render
from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu_torch.diff import adam, fit, make_train_step
from pathtracerpython_tpu_torch.diff.inverse import apply_params
from pathtracerpython_tpu_torch.ops.geometry import nearest_hit_cm
from torch_parallel_worker import (
    RING_TRAIN_CFG,
    VERTS,
    grad_scenes,
    nearest_grad_rays,
    nearest_loss,
    nearest_weights,
    ring_train_cases,
    ring_train_scene,
    ring_train_setup,
    spawn_ranks,
)
from torch_parity import to_jax_desc

WORLDS = (2, 4)
LOSS_RTOL = 1e-6
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-7
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-5, 1e-6
JAX_RTOL, JAX_ATOL = 1e-4, 1e-6
# 100 x Adam's eps: a gradient under it is not held through Adam's step
ADAM_SIGNAL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world -> every rank's arrays; a rank that waits forever on a reverse
    shift fails the module at the timeout."""
    return {w: spawn_ranks("ring_grad", w,
                           str(tmp_path_factory.mktemp(f"rg{w}")),
                           timeout=240.0)
            for w in WORLDS}


def hold_grad(got: np.ndarray, want: np.ndarray, what: str) -> None:
    assert np.isfinite(got).all(), what
    np.testing.assert_allclose(
        got, want, rtol=GRAD_RTOL,
        atol=GRAD_ATOL_SHARE * float(np.abs(want).max()), err_msg=what)


def _single_nearest(world: int, name: str, mode: str) -> dict:
    scene = grad_scenes(world)[name]
    o, d, _ = nearest_grad_rays(scene, world, 0, name)
    leaves = {f: getattr(scene, f).clone().requires_grad_(True)
              for f in VERTS}
    hit = nearest_hit_cm(o.T.contiguous(), d.T.contiguous(),
                         apply_params(scene, leaves), mode=mode)
    nearest_loss(hit, nearest_weights(o.shape[0])).backward()
    return {f: v.grad.numpy() for f, v in leaves.items()}


@pytest.mark.parametrize("mode", ["fast", "reference"])
@pytest.mark.parametrize("name", ["field", "tie", "nohit"])
@pytest.mark.parametrize("world", WORLDS)
def test_ring_nearest_grad_matches_single(ranks, world, name, mode):
    """Each rank's gradient lands on its home shard's rows only, and the
    ranks' gradients add up to the single process's."""
    want = _single_nearest(world, name, mode)
    key = f"nearest:{name}:{mode}"
    rows = want["tri_v0"].shape[0]
    per = rows // world
    for f, w in want.items():
        assert np.abs(w).max() > 0, f
        parts = [r[f"{key}:{f}"] for r in ranks[world]]
        for rank, part in enumerate(parts):
            away = np.ones(rows, bool)
            away[rank * per:(rank + 1) * per] = False
            assert not part[away].any(), (f, rank)
        hold_grad(sum(parts), w, f"{key}:{f}")


@pytest.mark.parametrize("mode", ["fast", "reference"])
@pytest.mark.parametrize("world", WORLDS)
def test_a_rank_with_no_hits_finishes(ranks, world, mode):
    """Rank 0's rays hit nothing, so its backward sends zeros; it still
    makes every reverse shift (the ranks finished), and the other ranks'
    gradients arrive on its rows."""
    key = f"nearest:nohit:{mode}"
    got = ranks[world]
    assert int(got[0][f"{key}:hits"]) == 0
    assert all(int(r[f"{key}:hits"]) > 0 for r in got[1:])
    per = got[0][f"{key}:tri_v0"].shape[0] // world
    assert np.abs(got[0][f"{key}:tri_v0"][:per]).max() > 0
    for r in got:
        assert r[f"{key}:counts"][1] == world - 1


def _single_step(name: str, world: int):
    kind, names, _, scene_name, over = ring_train_cases(world)[name]
    scene, cfg, target, params, opt = ring_train_setup(scene_name, kind,
                                                       names, over)
    loss = make_train_step(opt, scene, cfg, target)(params, (0, 5))
    return float(loss), {k: v.detach().numpy() for k, v in params.items()}, \
        {k: v.grad.numpy() for k, v in params.items()}


TRAIN = [(w, name) for w in WORLDS for name in ring_train_cases(w)]


@pytest.mark.parametrize("world,name", TRAIN)
def test_ring_train_step_matches_single(ranks, world, name):
    """Loss, gradients and params after the step. Adam's first step moves
    a param by lr * g / (|g| + 1e-8): where the gradient is rounding noise
    (an in-plane coordinate of an axis-aligned wall's vertex, exactly 0 in
    exact arithmetic, read at 1e-11 against a largest gradient of 3e-3),
    that is noise over eps, so Adam's params are held where |g| >=
    ADAM_SIGNAL; the gradients are held on every element."""
    kind = ring_train_cases(world)[name][0]
    loss, params, grads = _single_step(name, world)
    for rank in ranks[world]:
        np.testing.assert_allclose(float(rank[f"{name}:loss"]), loss,
                                   rtol=LOSS_RTOL)
        for k, v in params.items():
            assert np.abs(grads[k]).max() > 0, k
            hold_grad(rank[f"{name}:grad:{k}"], grads[k], f"{name}:{k}")
            held = (np.abs(grads[k]) >= ADAM_SIGNAL if kind == "adam"
                    else np.ones(v.shape, bool))
            assert held.sum() >= min(8, held.size), k
            np.testing.assert_allclose(rank[f"{name}:{k}"][held], v[held],
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_remat_under_the_ring_equals_the_step_without(ranks, world):
    """``remat_bounces`` recomputes each bounce inside the backward, its
    forward shifts included (twice the forward traffic), and gives the
    step without it bit for bit."""
    for rank in ranks[world]:
        for k in ("tri_v0", "tri_v1", "light_v0"):
            np.testing.assert_array_equal(rank[f"sgd_remat:{k}"],
                                          rank[f"sgd:{k}"])
            np.testing.assert_array_equal(rank[f"sgd_remat:grad:{k}"],
                                          rank[f"sgd:grad:{k}"])
        remat, plain = rank["sgd_remat:counts"], rank["sgd:counts"]
        assert remat[0] == 2 * plain[0] and remat[1] == plain[1]


@pytest.mark.parametrize("world", WORLDS)
def test_reverse_shifts_match_the_differentiable_chains(ranks, world):
    """Counts (forward shifts, reverse shifts, bytes sent, gradient bytes
    sent) are equal on every rank. A training step's chains: a nearest
    chain and an any-hit chain a bounce (reference mode adds the first
    occluder's), n - 1 shifts each; only the nearest chains shift back,
    the float TRI_FIELDS (13 floats a row) of a shard each time, behind
    the 8-byte number of the shift."""
    bounces = RING_TRAIN_CFG["n_bounces"]
    for name, (_, _, mesh_kw, scene_name, over) in \
            ring_train_cases(world).items():
        counts = [r[f"{name}:counts"] for r in ranks[world]]
        for c in counts[1:]:
            np.testing.assert_array_equal(c, counts[0], err_msg=name)
        shifts, back, _, back_bytes = counts[0]
        steps = mesh_kw["geom"] - 1
        chains = 3 if over.get("mode") == "reference" else 2
        recompute = 2 if over.get("remat_bounces") else 1
        assert back == bounces * steps, name
        assert shifts == recompute * chains * bounces * steps, name
        rows = ring_train_scene(scene_name)[1].num_padded_triangles
        assert back_bytes == back * ((rows // mesh_kw["geom"]) * 13 * 4
                                     + 8), name
    for r in ranks[world]:
        for name in ("field", "tie"):
            c = r[f"nearest:{name}:fast:counts"]
            assert c[0] == c[1] == world - 1


def test_mispaired_reverse_shifts_raise(ranks):
    """Ranks whose reverse shifts pair different forward shifts (rank 0
    numbered one shift more) both raise instead of adding each other's
    gradients."""
    for rank in ranks[2]:
        assert "received the reverse of shift" in str(rank["mispaired"])


def test_ring_fit_matches_single(ranks):
    scene, cfg, target, params, _ = ring_train_setup(
        "cornell", "adam", ("tri_v2", "light_v1"), {})
    got, losses = fit(params, adam(1e-2), scene, cfg, target, steps=2,
                      seed=4)
    for rank in ranks[2]:
        np.testing.assert_allclose(rank["fit:losses"], losses,
                                   rtol=LOSS_RTOL)
        for k, v in got.items():
            np.testing.assert_allclose(rank[f"fit:{k}"], v.numpy(),
                                       rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=k)


def _keep_grads() -> optax.GradientTransformation:
    """An optax transformation whose state is the last gradient it saw and
    whose update is zero: the sharded step then returns its summed
    gradient as the optimizer state."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (
            jax.tree_util.tree_map(jnp.zeros_like, g), g))


def test_ring_step_matches_jax(ranks):
    """The dp = 1 x geom = 2 step on ``tri_v0`` of the flat scene (offset
    eye): loss and gradient against the JAX package's sharded step on the
    same mesh shape."""
    desc, _ = ring_train_scene("flat")
    ref = jax_arrays.pack_scene(to_jax_desc(desc))
    cfg = JaxConfig(backend="pallas", **RING_TRAIN_CFG)
    target = jax_render(ref, cfg, seed=1)
    opt = _keep_grads()
    params = {"tri_v0": ref.tri_v0 + 0.05}
    mesh = jax_make_mesh(dp=1, geom=2, devices=jax.devices()[:2])
    step = jax_train_step(opt, ref, cfg, target, mesh=mesh, geom_axis="geom")
    _, grads, loss = step(params, opt.init(params), jax.random.PRNGKey(5))
    want = np.asarray(grads["tri_v0"])
    got = ranks[2][0]
    np.testing.assert_allclose(float(got["jax_flat:loss"]), float(loss),
                               rtol=LOSS_RTOL)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got["jax_flat:grad:tri_v0"], want,
                               rtol=JAX_RTOL, atol=JAX_ATOL)
