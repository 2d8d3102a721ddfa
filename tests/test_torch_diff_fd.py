"""The port's gradients against central finite differences of its own loss,
on the CPU: the cases of tests/test_diff.py that the hard-estimator slice
covers, at that file's tolerances, on its flat scene
(``synthetic.flat_scene``). The RNG is counter-based and fixed by the key,
so the loss is a deterministic function of the parameters and central
differences with one key are a valid oracle.

Mirrored: 6 material and emission fields, 3 vertex coordinates (floor and
light), 3 eye coordinates, 1 ortho coordinate, the light-vertex sync of
``apply_params``, ``pixel_loss``'s refusal of camera parameters, the albedo
fit and the eye fit. Checked to run: vertex gradients under a geometry
ring of one rank, equal to the unsharded loss's (rings of several ranks are
held in test_torch_ring_grad.py), and checkpointed fits (their resume is
held in test_torch_fit_checkpoint.py). The soft estimator's and
``remat_bounces``' gradients are held in test_torch_soft_fd.py and
test_torch_remat.py."""

import numpy as np
import pytest
import torch

from pathtracerpython_tpu_torch.diff import (
    adam,
    apply_params,
    camera_pixel_loss,
    fit,
    make_render_fn,
    pixel_loss,
)
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.render.integrator import render
from pathtracerpython_tpu_torch.scene import arrays, synthetic

KEY = (0, 0)  # jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: with one intra-op thread these tests take
    the same time alone and do not fight the other test workers for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def flat_scene():
    return arrays.pack_scene(synthetic.flat_scene(), device="cpu")


def center_rays(n=4):
    """A grid of rays through the window region (x, y near -0.5) that all
    hit the floor triangle's interior."""
    xs = torch.linspace(-0.2, 0.2, n)
    ys = torch.linspace(-0.6, -0.4, n)
    x, y = torch.meshgrid(xs, ys, indexing="ij")
    pts = torch.stack([x.ravel(), y.ravel(), torch.zeros(n * n)], dim=-1)
    eye = torch.tensor([0.0, 0.0, 3.0])
    return eye.expand(pts.shape), pts - eye


def loss_fn(scene, cfg, rays):
    origins, dirs = rays
    pids = torch.arange(origins.shape[0])
    target = torch.zeros((origins.shape[0], 3))
    render_fn = make_render_fn(cfg)
    return lambda p: pixel_loss(p, scene, target, render_fn, origins, dirs,
                                pids, KEY)


def camera_loss_fn(scene, cfg, seed=3):
    """The scene's own view against its render at ``seed``, as a function
    of a params dict: the in-loss ray generation path."""
    with torch.no_grad():
        target = render(scene, cfg, seed=seed)
    pids = torch.arange(scene.meta.width * scene.meta.height)
    render_fn = make_render_fn(cfg)
    return lambda p: camera_pixel_loss(p, scene, target, render_fn, pids,
                                       (0, seed))


def autodiff(f, params, field):
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    loss = f(leaves)
    loss.backward()
    assert torch.isfinite(loss)
    return leaves[field].grad


def central_fd(f, params, field, index, eps):
    with torch.no_grad():
        hi = {k: v.clone() for k, v in params.items()}
        lo = {k: v.clone() for k, v in params.items()}
        hi[field][index] += eps
        lo[field][index] -= eps
        return float((f(hi) - f(lo)) / (2.0 * eps))


@pytest.mark.parametrize("field,index,eps", [
    ("mat_rgb", (0, 0), 1e-2),
    ("mat_rgb", (0, 2), 1e-2),
    ("mat_ka", (0,), 1e-2),
    ("mat_kd", (0,), 1e-2),
    ("light_color", (1,), 1e-2),
    ("ambient", (), 1e-2),
])
def test_material_and_emission_grads_match_fd(flat_scene, field, index, eps):
    cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=2,
                       n_light_samples=2)
    params = {field: getattr(flat_scene, field)}
    f = loss_fn(flat_scene, cfg, center_rays())
    ad = float(autodiff(f, params, field)[index])
    fd = central_fd(f, params, field, index, eps)
    assert np.isfinite(ad)
    np.testing.assert_allclose(ad, fd, rtol=2e-2, atol=2e-5)


@pytest.mark.parametrize("field,index", [
    ("tri_v0", (0, 1)),    # floor vertex height
    ("tri_v0", (0, 0)),    # floor vertex x
    ("light_v0", (0, 1)),  # light vertex height (NEE geometry)
])
def test_vertex_grads_match_fd(flat_scene, field, index):
    cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=1,
                       n_light_samples=2)
    params = {field: getattr(flat_scene, field)}
    f = loss_fn(flat_scene, cfg, center_rays())
    ad = float(autodiff(f, params, field)[index])
    fd = central_fd(f, params, field, index, 2e-3)
    assert np.isfinite(ad)
    np.testing.assert_allclose(ad, fd, rtol=5e-2, atol=5e-5)


def test_light_vertex_grad_couples_tri_buffer(flat_scene):
    """Both light buffers exist: overriding ``light_v0`` moves the
    sampling buffer by exactly the override."""
    moved = apply_params(flat_scene, {"light_v0": flat_scene.light_v0 + 0.1})
    np.testing.assert_allclose(moved.light_v0.numpy(),
                               flat_scene.light_v0.numpy() + 0.1)


def test_light_vertex_override_syncs_tri_buffer(flat_scene):
    """``apply_params`` on ``light_v*`` moves the light's rows of the
    triangle buffer too, so hits, occlusion and emission see the geometry
    the NEE samples; the override's gradient reaches it through both, and
    the scene's own buffer is left as it was."""
    before = flat_scene.tri_v0.clone()
    light = (flat_scene.light_v0 + 0.2).requires_grad_(True)
    moved = apply_params(flat_scene, {"light_v0": light})
    rows = flat_scene.light_tri_rows.numpy()
    np.testing.assert_allclose(moved.tri_v0.detach().numpy()[rows],
                               flat_scene.light_v0.numpy() + 0.2, rtol=1e-6)
    assert torch.equal(flat_scene.tri_v0, before)
    (moved.tri_v0.sum() + moved.light_v0.sum()).backward()
    assert torch.equal(light.grad, torch.full_like(light, 2.0))


@pytest.mark.parametrize("index", [0, 1, 2])
def test_camera_eye_grad_matches_fd(flat_scene, index):
    cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=1,
                       n_light_samples=2)
    f = camera_loss_fn(flat_scene, cfg)
    params = {"eye": flat_scene.eye + torch.tensor([0.03, -0.02, 0.05])}
    ad = float(autodiff(f, params, "eye")[index])
    fd = central_fd(f, params, "eye", (index,), 2e-3)
    assert np.isfinite(ad)
    np.testing.assert_allclose(ad, fd, rtol=5e-2, atol=5e-5)


def test_camera_ortho_grad_matches_fd(flat_scene):
    cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=1,
                       n_light_samples=2)
    f = camera_loss_fn(flat_scene, cfg)
    params = {"ortho": flat_scene.ortho
              + torch.tensor([0.02, 0.0, -0.03, 0.01])}
    ad = float(autodiff(f, params, "ortho")[2])
    fd = central_fd(f, params, "ortho", (2,), 2e-3)
    np.testing.assert_allclose(ad, fd, rtol=5e-2, atol=5e-5)


def test_pixel_loss_rejects_camera_params(flat_scene):
    origins, dirs = center_rays()
    with pytest.raises(ValueError, match="camera"):
        pixel_loss({"eye": flat_scene.eye}, flat_scene,
                   torch.zeros((origins.shape[0], 3)),
                   make_render_fn(RenderConfig(mode="fast")), origins, dirs,
                   torch.arange(origins.shape[0]), KEY)


def test_inverse_fit_recovers_albedo(flat_scene):
    cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=2,
                       n_light_samples=2)
    with torch.no_grad():
        target = render(flat_scene, cfg, seed=7)
    params = {"mat_rgb": flat_scene.mat_rgb * 0.5}
    params, losses = fit(params, adam(0.05), flat_scene, cfg, target,
                         steps=30, seed=7)
    assert losses[-1] < losses[0] * 0.05, losses
    np.testing.assert_allclose(params["mat_rgb"].numpy()[0],
                               flat_scene.mat_rgb.numpy()[0], atol=0.05)


def test_camera_fit_recovers_eye(flat_scene):
    """Adam on the eye position recovers the true camera: target and loss
    share one key, so the loss is zero exactly at the true eye. Gated on
    the eye's error, as tests/test_diff.py gates it: the loss moves in
    steps as silhouettes cross pixel centers."""
    cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=1,
                       n_light_samples=2)
    f = camera_loss_fn(flat_scene, cfg)
    offset = torch.tensor([0.08, -0.06, 0.1])
    eye = (flat_scene.eye + offset).requires_grad_(True)
    opt = adam(0.02)([eye])
    for _ in range(100):
        opt.zero_grad()
        loss = f({"eye": eye})
        loss.backward()
        opt.step()
    err0 = float(offset.abs().max())
    err = float((eye.detach() - flat_scene.eye).abs().max())
    assert np.isfinite(float(loss.detach()))
    assert err < err0 * 0.35, (err0, err)


def test_sharded_and_checkpointed_fits_run(flat_scene, tmp_path):
    """Neither refuses any more: a vertex gradient under a geometry ring
    (here of one rank) is the unsharded loss's, bit for bit; a checkpointed
    fit runs and writes its step."""
    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
    from pathtracerpython_tpu_torch.parallel import make_mesh

    cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=1)
    w, h = flat_scene.meta.width, flat_scene.meta.height
    o, d = make_primary_rays(flat_scene.eye, flat_scene.ortho, w, h)
    grads = []
    for fn in (make_render_fn(cfg, mesh=make_mesh(device="cpu"),
                              geom_axis="geom"),
               make_render_fn(cfg)):
        v0 = flat_scene.tri_v0.clone().requires_grad_(True)
        fn(o, d, torch.arange(w * h), apply_params(
            flat_scene, {"tri_v0": v0}), 0).sum().backward()
        grads.append(v0.grad)
    assert grads[1].abs().max() > 0
    assert torch.equal(grads[0], grads[1])
    ckpt = tmp_path / "ckpt"
    _, losses = fit({"mat_rgb": flat_scene.mat_rgb}, adam(0.05), flat_scene,
                    cfg, torch.zeros((256, 3)), steps=1,
                    checkpoint_dir=str(ckpt), checkpoint_every=1)
    assert len(losses) == 1 and (ckpt / "step_00000001").is_dir()


def test_scene_cache_pins_no_graph_and_follows_new_vertices(flat_scene):
    """The sweeps' per-scene cache (Plücker packs, cull boxes) holds
    detached views, built without autograd, so it keeps no step's graph
    alive; a step's new vertex tensor rebuilds it."""
    import dataclasses

    from pathtracerpython_tpu_torch.kernels import intersect

    cfg = RenderConfig(mode="fast", n_samples=1, n_bounces=1,
                       n_light_samples=2, mt_impl="plucker")
    f = loss_fn(flat_scene, cfg, center_rays())
    v0 = flat_scene.tri_v0.clone().requires_grad_(True)
    f({"tri_v0": v0}).backward()
    cache = intersect._scene_cache
    assert cache["leaves"][0].data_ptr() == v0.data_ptr()
    assert not any(x.requires_grad for x in cache["leaves"])
    derived = [v for k, v in cache.items() if k not in ("key", "leaves")]
    assert derived and not any(
        x.requires_grad for v in derived
        for x in (v if isinstance(v, tuple) else (v,)))
    moved = (flat_scene.tri_v0 + 0.01).requires_grad_(True)
    intersect.scene_plucker_pack(dataclasses.replace(flat_scene,
                                                     tri_v0=moved))
    assert cache["leaves"][0].data_ptr() == moved.data_ptr()


def test_entries_call_the_sweeps_directly_without_grad_mode(flat_scene):
    """Under ``torch.no_grad`` a vertex leaf that requires grad does not
    send the entries through their Functions: the sweep's own result comes
    back and the any-hits' inputs pass as given; with grad mode on the
    nearest sweep runs under ``NearestTIdx``."""
    import dataclasses

    from pathtracerpython_tpu_torch.kernels import intersect

    scene = dataclasses.replace(
        flat_scene, tri_v0=flat_scene.tri_v0.clone().requires_grad_(True))
    o, d = center_rays()
    o3, d3 = o.T.contiguous(), (d / d.norm(dim=1, keepdim=True)).T.contiguous()
    maxd = torch.full((o3.shape[1],), 10.0)

    def sweep(o, d, sc):
        return intersect._nearest_t_idx(o, d, sc, None)

    with torch.no_grad():
        got = sweep(o3, d3, scene)
        direct = intersect.nearest_entry(lambda o, d, sc: got, o3, d3, scene)
        assert direct is got
        occ_in = intersect.detach_occlusion(o3, d3, maxd, scene)
        assert occ_in[3] is scene and occ_in[0] is o3
    t, idx = intersect.nearest_entry(sweep, o3, d3, scene)
    assert type(t.grad_fn).__name__ == "NearestTIdxBackward"
    assert torch.equal(t.detach(), got[0]) and torch.equal(idx, got[1])
    assert intersect.detach_occlusion(o3, d3, maxd, scene)[3] is not scene


def test_fit_albedo_without_a_scene_uses_the_stand_in():
    from pathtracerpython_tpu_torch.apps import fit_albedo

    scene, what = fit_albedo.load_fit_scene(None, "cpu")
    assert what.startswith("stand-in cornell_box_scene(128, 128)")
    assert (scene.meta.width, scene.meta.height) == (128, 128)
