"""The port's cluster soft sweeps (``diff/boundary.py``: per block of 256
rays, the triangles of the candidate clusters) on the 600-box field (7,296
triangles, morton order, past ``SOFT_ACCEL_MIN_TRIS``), against the dense
sweeps of both packages and the JAX package's own cluster sweeps, called
directly (plain XLA; each JAX cluster call at most 1,024 rays).

- The port's cluster records are its dense records bit for bit, and the JAX
  package's dense records on every lane but near ties
  (``torch_boundary_parity.py``).
- The JAX package's cluster sweep grows each cluster's box by the band
  alone and so misses near-misses by a vertex: on the field's 32x32
  camera rays its front record differs from its dense one on some lanes.
  The port's differs from JAX's cluster sweep only on those lanes.
- The JAX package pads a ragged last block with origin 1e6, which widens
  the block's box; the port repeats the last lane, so 1,000 rays' last
  block holds no more candidates than the 1,024 rays' that contain them.
- The cluster visibility drops only coverage terms of margin <= -band
  (each < sigmoid(-6)): held to the dense visibility within 5e-3 and its
  gradient within the JAX package's own bounds
  (``tests/test_soft_sparse.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracerpython_tpu.diff import boundary as jb
from pathtracerpython_tpu.scene.arrays import (
    recompute_derived as jax_recompute_derived,
)
from pathtracerpython_tpu_torch.diff import boundary as pb
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.scene import synthetic
from pathtracerpython_tpu_torch.scene.arrays import recompute_derived
from torch_boundary_parity import (
    extent,
    hold_records,
    jax_arrays,
    jax_records,
    near_tie_lanes,
    port_records,
)
from torch_parity import pack_pair

BETA = 0.03
VIS_ATOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the other test workers'
    cores free."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def field():
    scene, jax_scene = pack_pair(
        synthetic.box_field_scene(n_boxes=600, width=32, height=32),
        tri_order="morton")
    assert scene.tri_v0.shape[0] >= pb.SOFT_ACCEL_MIN_TRIS
    o, d = make_primary_rays(scene.eye, scene.ortho, 32, 32)
    return scene, jax_scene, (o.numpy(), d.numpy())


# floor patches whose shadow rays make one block each
PATCHES = ((-2.0, -4.0), (1.5, -7.0), (0.0, -12.0))


def _shadow_rays(field, seed: int):
    """Shadow rays of three floor patches (0.6 wide, 256 seeded points
    each) to seeded points of the light quad, as (origins, directions,
    distances) f32 numpy: one block of candidates each (63 to 150 of the
    240 clusters). Shadow rays from the whole camera view would span the
    field in every block, each block would take nearly every cluster, and
    the sweep would fall back to the dense one."""
    scene = field[0]
    rng = np.random.default_rng(seed)
    points = np.concatenate([np.stack([
        rng.uniform(x - 0.3, x + 0.3, 256), np.full(256, -0.99),
        rng.uniform(z - 0.3, z + 0.3, 256)], axis=1) for x, z in PATCHES])
    lv = [getattr(scene, f).numpy()[0] for f in ("light_v0", "light_v1",
                                                 "light_v2")]
    u = rng.uniform(size=(points.shape[0], 2))
    light = lv[0] + u[:, :1] * (lv[1] - lv[0]) + u[:, 1:] * (lv[2] - lv[1])
    vec = (light - points).astype(np.float32)
    dist = np.linalg.norm(vec, axis=-1).astype(np.float32)
    return points.astype(np.float32), vec, dist


def _camera_or_shadow(field, kind):
    if kind == "camera":
        return field[2]
    return _shadow_rays(field, seed=1)[:2]


@pytest.mark.parametrize("kind", ["shadow", "camera"])
def test_cluster_records_are_the_dense_records(field, kind):
    scene, jax_scene, _ = field
    o, d = _camera_or_shadow(field, kind)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    before = pb.FALLBACKS
    sparse = pb.soft_hits_sweep(ot, dt, scene, BETA)  # routes to the clusters
    assert pb.FALLBACKS == before
    dense = pb.soft_hits_sweep_dense(ot, dt, scene, BETA)
    for a, b in zip(sparse, dense):
        assert torch.equal(a, b)
    want = jax_records(jb.soft_hits_sweep_dense(*jax_arrays(o, d), jax_scene,
                                                BETA))
    differ = hold_records(port_records(sparse), want,
                          near_tie_lanes(o, d, scene, BETA),
                          extent(o, scene.tri_v0))
    print(kind, "lanes that differ from JAX's dense records (near ties):",
          differ)


def test_jax_cluster_front_misses_where_the_port_does_not(field):
    """Finding 1: the JAX package's cluster front record differs from its
    dense one on some camera lanes (its candidates miss the dense winner);
    the port's cluster records differ from JAX's cluster records on those
    lanes only."""
    scene, jax_scene, (o, d) = field
    jax_dense = jax_records(jb.soft_hits_sweep_dense(*jax_arrays(o, d),
                                                     jax_scene, BETA))
    jax_sparse = jax_records(jb.soft_hits_sweep_sparse(*jax_arrays(o, d),
                                                       jax_scene, BETA))
    port = port_records(pb.soft_hits_sweep_sparse(
        torch.from_numpy(o), torch.from_numpy(d), scene, BETA))
    missed = np.zeros(o.shape[0], bool)
    apart = np.zeros(o.shape[0], bool)
    for f in ("f_idx", "h1_idx", "h2_idx"):
        missed |= jax_sparse[f] != jax_dense[f]
        apart |= port[f] != jax_sparse[f]
    print(f"JAX's cluster sweep misses the dense winner on {missed.sum()} "
          f"of {o.shape[0]} lanes; the port differs from it on "
          f"{apart.sum()}")
    assert missed.any()
    assert not (apart & ~missed).any(), np.nonzero(apart & ~missed)[0]


def _last_block(n_lanes, o, d, scene, jax_scene):
    """(port, JAX) candidate count of the last block of the first
    ``n_lanes`` rays, each padded its package's way."""
    band = pb.BAND_SIGMAS * BETA
    o, d = o[:n_lanes], d[:n_lanes]
    nrb = -(-n_lanes // pb.SOFT_R_BLK)
    port = pb.soft_block_candidates(
        torch.from_numpy(o).T, pb.safe_normalize(torch.from_numpy(d)).T,
        torch.full((nrb,), pb.BIG), scene, band)
    o3p = jb._pad_cols(jnp.asarray(o).T, jb.SOFT_R_BLK, 1e6)
    d3p = jb._pad_cols(jb.safe_normalize(jnp.asarray(d)).T, jb.SOFT_R_BLK,
                       1.0)
    _, valid, _ = jb._soft_block_candidates(
        o3p, d3p, jnp.full((nrb,), jb.BIG), jax_scene, band, jb.SOFT_C_TRI,
        jb.SOFT_KMAX)
    assert not port.overflow
    return int(port.valid.sum(dim=1)[-1]), int(np.asarray(valid).sum(1)[-1])


def test_ragged_block_padding_does_not_widen_the_block(field):
    """Finding 2: at 1,000 rays the JAX package's last block (its 232 rays
    and 24 lanes at origin 1e6) holds more candidates than the 1,024 rays'
    last block that contains those rays; the port's holds no more."""
    scene, jax_scene, (o, d) = field
    port_1000, jax_1000 = _last_block(1000, o, d, scene, jax_scene)
    port_1024, jax_1024 = _last_block(1024, o, d, scene, jax_scene)
    print(f"last block's candidates: port {port_1000} (1,000 rays) and "
          f"{port_1024} (1,024); JAX {jax_1000} and {jax_1024}")
    assert jax_1000 > jax_1024
    assert port_1000 <= port_1024


def test_band_offset_box_holds_every_banded_point():
    """Seeded triangles and points of their planes: every point whose
    margin exceeds -band lies in the box of its band-offset triangle, and
    some lie outside the vertex box grown by the band alone (the JAX
    package's box)."""
    rng = np.random.default_rng(5)
    tri = rng.uniform(-1.0, 1.0, (64, 3, 3)).astype(np.float32)
    pack = np.zeros((64, 12), np.float32)
    pack[:, :9] = tri.reshape(64, 9)
    pack[:, 9] = 1.0
    band = 0.2
    grown = pb.band_offset_pack(torch.from_numpy(pack), band)
    box = grown[:, :9].reshape(64, 3, 3)
    lo, hi = box.amin(dim=1)[:, None], box.amax(dim=1)[:, None]
    w = rng.uniform(-2.0, 3.0, (64, 4000, 2)).astype(np.float32)
    bary = np.concatenate([1.0 - w.sum(-1, keepdims=True), w], axis=-1)
    points = torch.from_numpy(np.einsum("tpk,tkx->tpx", bary, tri))
    v0, v1, v2 = (torch.from_numpy(tri[:, None, k]) for k in range(3))
    normal = pb.safe_normalize(torch.linalg.cross(v1 - v0, v2 - v0, dim=-1))
    ok, _, margin = pb.plane_hit_and_margin(points + normal, -normal, v0, v1,
                                            v2)
    banded = ok & (margin > -band)
    inside = ((points >= lo - 1e-5) & (points <= hi + 1e-5)).all(dim=-1)
    assert banded.sum() > 1000
    assert inside[banded].all()
    vlo = torch.from_numpy(tri.min(axis=1))[:, None] - band
    vhi = torch.from_numpy(tri.max(axis=1))[:, None] + band
    in_vertex_box = ((points >= vlo) & (points <= vhi)).all(dim=-1)
    assert (banded & ~in_vertex_box).any()


def test_overflow_falls_back_to_the_dense_sweep(field, monkeypatch):
    scene, _, (o, d) = field
    ot, dt = torch.from_numpy(o[:300]), torch.from_numpy(d[:300])
    monkeypatch.setattr(pb, "SOFT_KMAX", 8)
    before = pb.FALLBACKS
    got = pb.soft_hits_sweep_sparse(ot, dt, scene, BETA)
    assert pb.FALLBACKS == before + 1
    for a, b in zip(got, pb.soft_hits_sweep_dense(ot, dt, scene, BETA)):
        assert torch.equal(a, b)
    maxd = torch.full((300,), 10.0)
    vis = pb.soft_visibility_sparse(ot, dt, maxd, scene, BETA)
    assert pb.FALLBACKS == before + 2
    assert torch.equal(vis, 1.0 - torch.minimum(
        pb._soft_visibility_cov(ot, dt, maxd, scene, BETA), torch.ones(300)))


def test_cluster_visibility_matches_dense(field):
    scene, jax_scene, _ = field
    o, d, maxd = _shadow_rays(field, seed=0)
    args = [torch.from_numpy(x) for x in (o, d, maxd)]
    before = pb.FALLBACKS
    sparse = pb.soft_visibility(*args, scene, BETA).numpy()
    assert pb.FALLBACKS == before
    dense = 1.0 - np.minimum(
        pb._soft_visibility_cov(*args, scene, BETA).numpy(), 1.0)
    np.testing.assert_allclose(sparse, dense, rtol=0, atol=VIS_ATOL)
    assert (dense < 1.0).mean() > 0.1
    want = 1.0 - np.minimum(np.asarray(jb._soft_visibility_cov(
        *jax_arrays(o, d, maxd), jax_scene, BETA)), 1.0)
    np.testing.assert_allclose(sparse, want, rtol=0, atol=VIS_ATOL)


def test_cluster_visibility_grad_matches_dense(field):
    """d/dx of the mean visibility under a shift of the whole scene, as
    ``tests/test_soft_sparse.py`` holds the JAX package's: the port's
    cluster sweep against its dense sweep, and against the JAX package's
    dense gradient."""
    scene, jax_scene, _ = field
    o, d, maxd = _shadow_rays(field, seed=2)
    args = [torch.from_numpy(x) for x in (o, d, maxd)]

    def port_grad(fn):
        dx = torch.zeros((), requires_grad=True)
        shift = torch.stack([dx, torch.zeros(()), torch.zeros(())])
        sc = recompute_derived(dataclasses.replace(
            scene, **{f: getattr(scene, f) + shift
                      for f in ("tri_v0", "tri_v1", "tri_v2")}))
        fn(*args, sc, BETA).mean().backward()
        return float(dx.grad)

    def dense(*a):
        return 1.0 - torch.minimum(pb._soft_visibility_cov(*a),
                                   torch.ones(o.shape[0]))

    def jax_loss(dx):
        shift = jnp.asarray([1.0, 0.0, 0.0]) * dx
        sc = jax_recompute_derived(dataclasses.replace(
            jax_scene, **{f: getattr(jax_scene, f) + shift
                          for f in ("tri_v0", "tri_v1", "tri_v2")}))
        return jnp.mean(1.0 - jnp.minimum(jb._soft_visibility_cov(
            *jax_arrays(o, d, maxd), sc, BETA), 1.0))

    before = pb.FALLBACKS
    g_sparse = port_grad(pb.soft_visibility)
    assert pb.FALLBACKS == before
    g_dense = port_grad(dense)
    g_jax = float(jax.grad(jax_loss)(0.0))
    assert abs(g_dense) > 1e-6
    np.testing.assert_allclose(g_sparse, g_dense, rtol=5e-2, atol=1e-5)
    np.testing.assert_allclose(g_dense, g_jax, rtol=1e-4, atol=1e-7)
