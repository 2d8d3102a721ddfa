"""The port's gradient path against the JAX package's on the same inputs, on
the CPU: the loss and the gradients of every scene and camera field through
``pixel_loss`` and ``camera_pixel_loss`` on tests/test_diff.py's flat
scene (fused NEE, unfused NEE with 9 samples, the Plücker form), the
sweeps' and the fused NEE's backwards against ``jax.vjp`` of the JAX
entries, ``intersect_moller``, ``recompute_derived``, the transforms,
``rng.split`` and five steps of ``fit`` against JAX ``fit`` with
``optax.adam``. The JAX package runs ``backend="pallas"`` with its Pallas
kernels in interpret mode, as test_torch_render.py runs it.

Tolerances: torch_diff_parity.py's for the losses and gradients (loss 1e-6
relative, 1e-4 relative L2 per field); the rest are stated where used.
Finite-difference checks of the port alone are in test_torch_diff_fd.py,
the Cornell cases in test_torch_diff_cornell.py and the hierarchies in
test_torch_diff_hier.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pathtracerpython_tpu.diff import fit as jax_fit
from pathtracerpython_tpu.diff import transforms as jax_transforms
from pathtracerpython_tpu.kernels import intersect_pallas as ip
from pathtracerpython_tpu.kernels import nee_pallas
from pathtracerpython_tpu.ops.geometry import (
    intersect_moller as jax_intersect_moller,
)
from pathtracerpython_tpu.render.config import RenderConfig as JaxConfig
from pathtracerpython_tpu.render.integrator import render as jax_render
from pathtracerpython_tpu.scene.arrays import (
    recompute_derived as jax_recompute_derived,
)
from pathtracerpython_tpu_torch.diff import adam, fit, transforms
from pathtracerpython_tpu_torch.kernels import intersect, nee
from pathtracerpython_tpu_torch.ops import rng
from pathtracerpython_tpu_torch.ops.geometry import (
    intersect_moller,
    normalize3,
)
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.scene.arrays import recompute_derived
from pathtracerpython_tpu_torch.scene import synthetic
from torch_diff_parity import EYE_OFFSET, center_rays, run_case
from torch_parity import pack_pair

# values of a unit against its JAX twin: the same float32 formulas, which
# XLA:CPU may fuse differently
VALUE_RTOL = 1e-6
VALUE_ATOL = 1e-6
# gradients of a unit: relative L2 over the whole array
UNIT_GRAD_RTOL = 1e-5
BASE = dict(n_samples=1, n_bounces=2)
CASES = {
    "fused": (dict(n_light_samples=2), "classic"),
    "unfused9": (dict(n_light_samples=9), "classic"),
    "plucker": (dict(n_light_samples=2), "plucker"),
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
def flat():
    return pack_pair(synthetic.flat_scene())


@pytest.fixture(scope="module")
def cornell():
    return pack_pair(synthetic.cornell_box_scene(16, 16), pad_to=32)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize("loss", ["camera", "pixel"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flat_loss_and_grads_match_jax(flat, case, loss):
    cfg_kw, mt_impl = CASES[case]
    rays = None if loss == "camera" else center_rays()
    worst = run_case(*flat, {**BASE, **cfg_kw}, loss == "camera", mt_impl,
                     rays)
    print(f"{case} {loss}: worst relative L2 {worst:.3g}")


def test_intersect_moller_matches_jax():
    rs = np.random.default_rng(0)
    n = 64
    o = rs.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # each ray's triangle around a point 2-5 along it, so most rays hit
    c = o + d * rs.uniform(2, 5, (n, 1)).astype(np.float32)
    vs = [(c + rs.normal(scale=0.5, size=(n, 3))).astype(np.float32)
          for _ in range(3)]
    w = rs.normal(size=n).astype(np.float32)
    args = [o, d, *vs]

    def jf(*a):
        return jnp.sum(jax_intersect_moller(*a)[1] * w)

    jhit, jt = jax_intersect_moller(*map(jnp.asarray, args))
    jgrads = jax.grad(jf, argnums=tuple(range(5)))(*map(jnp.asarray, args))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    hit, t = intersect_moller(*leaves)
    (t * torch.from_numpy(w)).sum().backward()
    assert 0.1 < hit.float().mean() < 1.0
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(jt),
                               rtol=VALUE_RTOL, atol=VALUE_ATOL)
    for leaf, want in zip(leaves, jgrads):
        assert rel_l2(leaf.grad.numpy(), want) <= UNIT_GRAD_RTOL


def _vertex_fields(jax_scene, jitter: float, seed: int) -> dict:
    """The scene's vertex buffers moved by a seeded jitter (the padding
    rows stay degenerate)."""
    rs = np.random.default_rng(seed)
    valid = np.asarray(jax_scene.tri_valid)[:, None]
    out = {}
    for f in ("tri_v0", "tri_v1", "tri_v2", "light_v0", "light_v1",
              "light_v2"):
        v = np.array(getattr(jax_scene, f))
        noise = rs.normal(scale=jitter, size=v.shape).astype(np.float32)
        out[f] = v + (noise * valid if f.startswith("tri") else noise)
    return out


def test_recompute_derived_matches_jax(cornell):
    scene, jax_scene = cornell
    fields = _vertex_fields(jax_scene, 0.05, seed=1)
    rs = np.random.default_rng(2)
    weights = {k: rs.normal(size=np.shape(getattr(jax_scene, k))).astype(
        np.float32) for k in ("tri_normal", "tri_area", "light_area")}

    def jf(p):
        out = jax_recompute_derived(dataclasses.replace(jax_scene, **p))
        return sum(jnp.sum(getattr(out, k) * w) for k, w in weights.items())

    jp = {k: jnp.asarray(v) for k, v in fields.items()}
    want = jax_recompute_derived(dataclasses.replace(jax_scene, **jp))
    jgrads = jax.grad(jf)(jp)
    leaves = {k: torch.from_numpy(v).requires_grad_(True)
              for k, v in fields.items()}
    got = recompute_derived(dataclasses.replace(scene, **leaves))
    sum((getattr(got, k) * torch.from_numpy(w)).sum()
        for k, w in weights.items()).backward()
    for k in weights:
        np.testing.assert_allclose(getattr(got, k).detach().numpy(),
                                   np.asarray(getattr(want, k)),
                                   rtol=VALUE_RTOL, atol=VALUE_ATOL)
    pad = ~scene.tri_valid.numpy()
    assert pad.any()
    for k, leaf in leaves.items():
        g = leaf.grad.numpy()
        assert np.isfinite(g).all(), k  # degenerate rows: zero, not NaN
        if k.startswith("tri"):
            assert not g[pad].any(), k
        assert rel_l2(g, jgrads[k]) <= UNIT_GRAD_RTOL, k


# name -> (JAX function, port function, pose arguments as numpy)
TRANSFORMS = {
    "translate_object": ("translate_object", [(0.3, -0.2, 0.1)]),
    "rotate_object": ("rotate_object", [0.4]),
    "transform_object": ("transform_object", [(0.3, -0.2, 0.1), 0.4]),
    "rotate_object_euler": ("rotate_object_euler", [(0.2, -0.3, 0.25)]),
    "transform_object_full": ("transform_object_full",
                              [(0.3, -0.2, 0.1), (0.2, -0.3, 0.25)]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(cornell, name):
    scene, jax_scene = cornell
    fn_name, pose = TRANSFORMS[name]
    obj = 5  # the tall cube
    pose = [np.asarray(p, np.float32) for p in pose]
    rs = np.random.default_rng(3)
    weights = {k: rs.normal(size=np.shape(getattr(jax_scene, k))).astype(
        np.float32) for k in ("tri_v0", "tri_v1", "tri_v2", "tri_normal")}

    def jf(*p):
        out = getattr(jax_transforms, fn_name)(jax_scene, obj, *p)
        return sum(jnp.sum(getattr(out, k) * w) for k, w in weights.items())

    jpose = [jnp.asarray(p) for p in pose]
    want = getattr(jax_transforms, fn_name)(jax_scene, obj, *jpose)
    jgrads = jax.grad(jf, argnums=tuple(range(len(pose))))(*jpose)
    leaves = [torch.from_numpy(p).requires_grad_(True) for p in pose]
    got = getattr(transforms, fn_name)(scene, obj, *leaves)
    sum((getattr(got, k) * torch.from_numpy(w)).sum()
        for k, w in weights.items()).backward()
    moved = (got.tri_material == obj).numpy()
    assert moved.sum() == 12
    for k in weights:
        g = getattr(got, k).detach().numpy()
        np.testing.assert_allclose(g, np.asarray(getattr(want, k)),
                                   rtol=VALUE_RTOL, atol=VALUE_ATOL)
        assert not (g[~moved] - getattr(scene, k).numpy()[~moved]).any()
    for leaf, jg in zip(leaves, jgrads):
        assert np.abs(np.asarray(jg)).max() > 0
        assert rel_l2(leaf.grad.numpy(), jg) <= UNIT_GRAD_RTOL
    np.testing.assert_allclose(
        transforms.object_centroid(scene, obj).numpy(),
        np.asarray(jax_transforms.object_centroid(jax_scene, obj)),
        rtol=VALUE_RTOL, atol=VALUE_ATOL)


@pytest.mark.parametrize("seed", [0, 7, 123456789, 2**32 - 1])
def test_split_is_jax_random_split(seed):
    assert jax.config.jax_threefry_partitionable
    key = jax.random.PRNGKey(seed)
    port = rng.key_from_seed(seed)
    assert port == tuple(int(k) for k in jax.random.key_data(key))
    for _ in range(3):  # fit's walk: key, sub = split(key)
        for num in (2, 3):
            want = [tuple(int(w) for w in k)
                    for k in np.asarray(jax.random.split(key, num))]
            assert rng.split(port, num) == want
        key, _ = jax.random.split(key)
        port, _ = rng.split(port)


def _nee_inputs(scene, n: int = 512, s: int = 3, seed: int = 4):
    """Shading points on the Cornell floor and walls with their normals and
    the NEE's uniforms, as numpy."""
    rs = np.random.default_rng(seed)
    o, d = (x.numpy() for x in intersect_inputs(scene, n, seed))
    t, idx = intersect.nearest_t_idx_cm(torch.from_numpy(o),
                                        torch.from_numpy(d), scene)
    point3 = (o + d * t.numpy()[None]).astype(np.float32)
    normal3 = scene.tri_normal.numpy()[idx.clamp_min(0).numpy()].T.copy()
    u = rs.uniform(size=(5 * s, n)).astype(np.float32)
    return point3, np.ascontiguousarray(normal3), u


def intersect_inputs(scene, n: int, seed: int):
    """n rays from the eye through the view window, jittered."""
    rs = np.random.default_rng(seed)
    o = np.repeat(scene.eye.numpy()[:, None], n, axis=1).astype(np.float32)
    pts = np.stack([rs.uniform(-0.95, 0.95, n), rs.uniform(-0.95, 0.95, n),
                    np.zeros(n)]).astype(np.float32)
    return torch.from_numpy(o), normalize3(torch.from_numpy(pts - o))


def test_nee_backward_matches_jax_vjp(cornell):
    scene, jax_scene = cornell
    s = 3
    point3, normal3, u = _nee_inputs(scene, s=s)
    g = np.random.default_rng(5).normal(size=(1, point3.shape[1])).astype(
        np.float32)
    tripack = ip.pack_triangles(jax_scene.tri_v0, jax_scene.tri_v1,
                                jax_scene.tri_v2, jax_scene.tri_valid,
                                jax_scene.tri_occluder)
    tripack = ip._pad_dim(tripack, min(ip.T_BLK, tripack.shape[0]), axis=0)
    lightpack = nee_pallas._light_pack(jax_scene)

    def jf(p3, n3, a, b, c):
        return nee_pallas.nee_mean_cos(p3, n3, a, b, c, jax_scene.light_area,
                                       jnp.asarray(u), tripack, lightpack, s)

    lights = [np.asarray(getattr(jax_scene, f))
              for f in ("light_v0", "light_v1", "light_v2")]
    want_mc, vjp = jax.vjp(jf, jnp.asarray(point3), jnp.asarray(normal3),
                           *map(jnp.asarray, lights))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(x.copy()).requires_grad_(True)
              for x in (point3, normal3, *lights)]
    sc = dataclasses.replace(scene, light_v0=leaves[2], light_v1=leaves[3],
                             light_v2=leaves[4])
    mc, occ = nee.nee_mean_cos_fused(leaves[0], leaves[1],
                                     torch.from_numpy(u), sc, s)
    assert not occ.requires_grad and 0.05 < occ.mean() < 0.95
    np.testing.assert_allclose(mc.detach().numpy(), np.asarray(want_mc),
                               rtol=VALUE_RTOL, atol=1e-5)
    mc.backward(torch.from_numpy(g))
    for leaf, w in zip(leaves, want):
        assert np.abs(np.asarray(w)).max() > 0
        assert rel_l2(leaf.grad.numpy(), w) <= UNIT_GRAD_RTOL


@pytest.mark.parametrize("mt_impl", ["classic", "plucker"])
def test_nearest_backward_matches_jax_vjp(cornell, mt_impl, monkeypatch):
    scene, jax_scene = cornell
    o3, d3 = intersect_inputs(scene, 512, seed=6)
    g = np.random.default_rng(7).normal(size=o3.shape[1]).astype(np.float32)
    monkeypatch.setattr(ip, "MT_IMPL", mt_impl)
    verts = [np.asarray(getattr(jax_scene, f))
             for f in ("tri_v0", "tri_v1", "tri_v2")]

    def jf(o, d, a, b, c):
        sc = dataclasses.replace(jax_scene, tri_v0=a, tri_v1=b, tri_v2=c)
        return ip.nearest_t_idx_cm(o, d, sc)[0]

    want_t, vjp = jax.vjp(jf, jnp.asarray(o3.numpy()),
                          jnp.asarray(d3.numpy()), *map(jnp.asarray, verts))
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(np.array(x)).requires_grad_(True)
              for x in (o3.numpy(), d3.numpy(), *verts)]
    sc = dataclasses.replace(scene, tri_v0=leaves[2], tri_v1=leaves[3],
                             tri_v2=leaves[4])
    t, idx = intersect.nearest_t_idx_cm(leaves[0], leaves[1], sc,
                                        mt_impl=mt_impl)
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(want_t),
                               rtol=VALUE_RTOL, atol=VALUE_ATOL)
    t.backward(torch.from_numpy(g))
    for leaf, w in zip(leaves, want):
        assert np.abs(np.asarray(w)).max() > 0
        assert rel_l2(leaf.grad.numpy(), w) <= UNIT_GRAD_RTOL


def test_fit_matches_jax_fit():
    """Five steps of ``fit`` against JAX ``fit`` with ``optax.adam`` from
    the same start, target and seed: losses within 1e-5 relative and
    params within 1e-5 (Adam's steps are about lr = 0.05; the two round
    the update in another order)."""
    # the flat scene seen from EYE_OFFSET off its eye: from its own eye one
    # 16x16 pixel's ray grazes the light's edge, where a winner may flip
    # between the two packages
    eye = np.float32([0.0, 0.0, 3.0]) + np.float32(EYE_OFFSET)
    desc = dataclasses.replace(synthetic.flat_scene(),
                               eye=tuple(float(x) for x in eye))
    scene, jax_scene = pack_pair(desc)
    kw = dict(n_samples=1, n_bounces=2, n_light_samples=2)
    target = np.asarray(jax_render(jax_scene, JaxConfig(
        mode="fast", backend="pallas", **kw), seed=7))
    start = {"mat_rgb": np.asarray(jax_scene.mat_rgb) * 0.5,
             "light_color": np.asarray(jax_scene.light_color) * 1.5}
    want_params, want_losses = jax_fit(
        {k: jnp.asarray(v) for k, v in start.items()}, optax.adam(0.05),
        jax_scene, JaxConfig(mode="fast", backend="pallas", **kw),
        jnp.asarray(target), steps=5, seed=7)
    got_params, got_losses = fit(
        {k: torch.from_numpy(v.copy()) for k, v in start.items()},
        adam(0.05), scene, RenderConfig(mode="fast", **kw),
        torch.from_numpy(target.copy()), steps=5, seed=7)
    assert len(got_losses) == 5 and got_losses[-1] < got_losses[0]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    for k, v in want_params.items():
        assert not got_params[k].requires_grad
        np.testing.assert_allclose(got_params[k].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-5)
