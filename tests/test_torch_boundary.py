"""The port's dense soft sweeps (``diff/boundary.py``) against the JAX
package's, called directly (plain XLA, no Pallas): the plane solve and edge
margin, the F / hit1 / hit2 records and the shadow visibility, with their
gradients, on seeded rays and on the camera rays of the occluder scene of
``tests/test_boundary.py`` and of the Cornell stand-in.

Tolerances (``torch_boundary_parity.py``): t and margin within rtol 1e-6
and atol 1e-6 per unit of the scene's extent; indices equal but on
near-tie lanes; visibility within atol 1e-6. Gradients within 1e-5
relative L2, the visibility's away from the clamp's kink: a shadow ray through the interior of one quad sums the two
triangles' coverages sigmoid(m) + sigmoid(-m), which is 1 up to rounding,
and ``min(cov, 1)`` has a kink there whose gradient (0, 1/2 or 1) follows
the last bit of the sum, which the packages round apart."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.diff import boundary as jb
from pathtracerpython_tpu_torch.diff import boundary as pb
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.scene import synthetic
from torch_boundary_parity import (
    T_ATOL,
    T_RTOL,
    extent,
    hold_records,
    jax_arrays,
    jax_records,
    near_tie_lanes,
    port_records,
    seeded_rays,
)
from torch_parity import pack_pair

BETA = 0.05
GRAD_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the other test workers'
    cores free."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scenes():
    return {"occluder": pack_pair(synthetic.occluder_scene()),
            "cornell": pack_pair(synthetic.cornell_box_scene(16, 16))}


def _rays(scene, kind):
    if kind == "camera":
        o, d = make_primary_rays(scene.eye, scene.ortho, scene.meta.width,
                                 scene.meta.height)
        return o.numpy(), d.numpy()
    lo = scene.tri_v0[scene.tri_valid].amin(dim=0).numpy()
    hi = scene.tri_v0[scene.tri_valid].amax(dim=0).numpy()
    return seeded_rays(700, lo, hi, seed=1)


def test_plane_hit_and_margin_matches_jax():
    """Seeded rays against seeded triangles: ``ok`` equal on every pair, t
    and margin within the bounds of ``torch_boundary_parity`` times
    1 / |cos| of the angle between ray and normal, by which a grazing ray
    amplifies the intermediates' rounding (measured: 17 of 5,845 pairs at
    |cos| >= 0.05 beyond the bounds unscaled, up to 5.8e-6 relative)."""
    rng = np.random.default_rng(0)
    o, d = seeded_rays(64, [-1, -1, -1], [1, 1, 1])
    v = rng.uniform(-2, 2, (3, 96, 3)).astype(np.float32)
    got = pb.plane_hit_and_margin(
        torch.from_numpy(o)[:, None], pb.safe_normalize(torch.from_numpy(d))[
            :, None], *(torch.from_numpy(x)[None] for x in v))
    want = jb.plane_hit_and_margin(
        jnp.asarray(o)[:, None], jb.safe_normalize(jnp.asarray(d))[:, None],
        *(jnp.asarray(x)[None] for x in v))
    ok = np.asarray(want[0])
    assert np.array_equal(got[0].numpy(), ok)
    assert ok.mean() > 0.99
    normal = np.cross(v[1] - v[0], v[2] - v[0])
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    d_unit = d / np.linalg.norm(d, axis=-1, keepdims=True)
    cos = np.abs(d_unit @ normal.T)
    for g, w in zip(got[1:], want[1:]):
        g, w = g.numpy()[ok], np.asarray(w)[ok]
        bound = (T_RTOL * np.abs(w) + T_ATOL * extent(o, v)) / cos[ok]
        assert (np.abs(g - w) <= bound).all(), np.abs(g - w).max()


@pytest.mark.parametrize("kind", ["seeded", "camera"])
@pytest.mark.parametrize("which", ["occluder", "cornell"])
def test_dense_records_match_jax(scenes, which, kind):
    scene, jax_scene = scenes[which]
    o, d = _rays(scene, kind)
    got = port_records(pb.soft_hits_sweep_dense(
        torch.from_numpy(o), torch.from_numpy(d), scene, BETA))
    want = jax_records(jb.soft_hits_sweep_dense(*jax_arrays(o, d),
                                                jax_scene, BETA))
    differ = hold_records(got, want, near_tie_lanes(o, d, scene, BETA),
                          extent(o, scene.tri_v0))
    found = {k: (want[k] != jb.IMAX).mean() for k in ("f_idx", "h1_idx")}
    print(which, kind, "lanes that differ (near ties):", differ,
          "share found:", found)
    assert found["f_idx"] > 0.3 and found["h1_idx"] > 0.3


@pytest.mark.parametrize("which", ["occluder", "cornell"])
def test_dense_visibility_matches_jax(scenes, which):
    scene, jax_scene = scenes[which]
    o, d = _rays(scene, "seeded")
    maxd = np.random.default_rng(2).uniform(0.5, 8.0, o.shape[0]).astype(
        np.float32)
    got = pb.soft_visibility(*(torch.from_numpy(x) for x in (o, d, maxd)),
                             scene, BETA).numpy()
    want = np.asarray(jb.soft_visibility(*jax_arrays(o, d, maxd), jax_scene,
                                         BETA))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert 0.05 < (want < 1.0).mean() < 0.95  # shadows and light both


def test_dense_visibility_grad_matches_jax(scenes):
    """d/d tri_v0 of a weighted sum of visibilities, away from the clamp's
    kink (the weights are 0 on lanes whose coverage either package puts
    within 1e-5 of 1)."""
    scene, jax_scene = scenes["occluder"]
    o, d = _rays(scene, "seeded")
    maxd = np.random.default_rng(2).uniform(0.5, 8.0, o.shape[0]).astype(
        np.float32)
    cov_p = pb._soft_visibility_cov(*(torch.from_numpy(x) for x in (
        o, d, maxd)), scene, BETA).numpy()
    cov_j = np.asarray(jb._soft_visibility_cov(*jax_arrays(o, d, maxd),
                                               jax_scene, BETA))
    away = (np.abs(cov_p - 1) > 1e-5) & (np.abs(cov_j - 1) > 1e-5)
    w = (np.random.default_rng(3).normal(size=o.shape[0]) * away).astype(
        np.float32)

    def jax_loss(v0):
        sc = dataclasses.replace(jax_scene, tri_v0=v0)
        return jnp.sum(jb.soft_visibility(*jax_arrays(o, d, maxd), sc, BETA)
                       * w)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(jax_scene.tri_v0)))
    v0 = scene.tri_v0.clone().requires_grad_(True)
    vis = pb.soft_visibility(*(torch.from_numpy(x) for x in (o, d, maxd)),
                             dataclasses.replace(scene, tri_v0=v0), BETA)
    (vis * torch.from_numpy(w)).sum().backward()
    got = v0.grad.numpy()
    assert np.linalg.norm(want) > 0
    assert np.linalg.norm(got - want) <= GRAD_RTOL * np.linalg.norm(want)


@pytest.mark.parametrize("field", ["f_t", "f_margin", "h1_t", "h2_t"])
def test_dense_record_grads_match_jax(scenes, field):
    """d/d tri_v0 of a weighted sum of one record over the lanes that found
    it: the gather through argmin, the merges and the plane solve."""
    scene, jax_scene = scenes["occluder"]
    o, d = _rays(scene, "seeded")
    w = np.random.default_rng(4).normal(size=o.shape[0]).astype(np.float32)
    idx = {"f_t": "f_idx", "f_margin": "f_idx", "h1_t": "h1_idx",
           "h2_t": "h2_idx"}[field]

    def jax_loss(v0):
        rec = jb.soft_hits_sweep_dense(
            *jax_arrays(o, d), dataclasses.replace(jax_scene, tri_v0=v0),
            BETA)
        found = getattr(rec, idx) != jb.IMAX
        return jnp.sum(jnp.where(found, getattr(rec, field), 0.0) * w)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(jax_scene.tri_v0)))
    v0 = scene.tri_v0.clone().requires_grad_(True)
    rec = pb.soft_hits_sweep_dense(*(torch.from_numpy(x) for x in (o, d)),
                                   dataclasses.replace(scene, tri_v0=v0),
                                   BETA)
    found = getattr(rec, idx) != pb.IMAX
    (torch.where(found, getattr(rec, field), 0.0)
     * torch.from_numpy(w)).sum().backward()
    got = v0.grad.numpy()
    assert np.linalg.norm(want) > 0
    assert np.linalg.norm(got - want) <= GRAD_RTOL * np.linalg.norm(want)


def test_ragged_tile_gives_the_one_tile_records(monkeypatch):
    """A scene whose row count the tile does not divide (the occluder
    scene's 6 rows packed with pad_to=2, tiles of 4): the port's ragged
    last tile names its own rows, so the records are the one-tile sweep's,
    bit for bit, and the coverage its sum in another order. The JAX sweep's
    ``dynamic_slice`` shifts that tile back to rows 2-5 but names them 4-7,
    so some of its records name a row past the buffer (ROADMAP queue C)."""
    scene, jax_scene = pack_pair(synthetic.occluder_scene(), pad_to=2)
    rows = scene.tri_v0.shape[0]
    o, d = _rays(scene, "seeded")
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    maxd = torch.full((o.shape[0],), 6.0)
    assert rows % 4 != 0
    monkeypatch.setattr(pb, "TILE", 4096)
    one = pb.soft_hits_sweep_dense(ot, dt, scene, BETA)
    one_vis = pb.soft_visibility(ot, dt, maxd, scene, BETA)
    monkeypatch.setattr(pb, "TILE", 4)
    ragged = pb.soft_hits_sweep_dense(ot, dt, scene, BETA)
    for a, b in zip(one, ragged):
        assert torch.equal(a, b)
    torch.testing.assert_close(pb.soft_visibility(ot, dt, maxd, scene, BETA),
                               one_vis, rtol=0, atol=1e-6)
    want = jb.soft_hits_sweep_dense(*jax_arrays(o, d), jax_scene, BETA,
                                    tile=4)
    past = {}
    for f in ("f_idx", "h1_idx", "h2_idx"):
        j = np.asarray(getattr(want, f))
        p = getattr(ragged, f).numpy()
        past[f] = int(((j != jb.IMAX) & (j >= rows)).sum())
        assert not ((p != pb.IMAX) & (p >= rows)).any()
    print(f"JAX's records naming a row past the {rows}-row buffer, of "
          f"{o.shape[0]} rays: {past}")
    assert sum(past.values()) > 0
