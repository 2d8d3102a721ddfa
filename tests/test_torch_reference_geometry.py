"""The port's reference-mode geometry (``ops/geometry.py``:
``intersect_reference``, the row-major ``nearest_hit`` in both modes,
``any_hit_within``, ``first_occluder_index`` and ``resolve_hit_attributes``)
against the JAX package's, on seeded rays and the in-repo scenes.

Tolerances: both packages compute the same float32 operations in the same
order, but XLA:CPU's rsqrt rounds differently from PyTorch's in the last
bit, so t agrees to rtol = 1e-5 (atol 1e-6), and a hit, a winner or an
occlusion bit may differ only on a lane whose ray passes within
GRAZING_MARGIN of a triangle edge (float64 barycentric margin), whose
winner ties with a coplanar row's t within that tolerance, or whose
squared distance lies within rounding of ZERO or of the shadow limit.
Everything else is equal, bit for bit where the port computes the same
value twice (tiles, chunks)."""

import numpy as np
import pytest
import torch

from pathtracerpython_tpu.ops import geometry as jgeo
from pathtracerpython_tpu_torch.ops import geometry as geo
from pathtracerpython_tpu_torch.scene import synthetic
from pathtracerpython_tpu_torch.scene.obj import mesh_from_arrays
from pathtracerpython_tpu_torch.scene.sdl import SceneDescription, SdlObject
from torch_parity import GRAZING_MARGIN, bary_margin_f64, pack_pair

T_RTOL, T_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the time of a test alone and
    leaves the other test workers their cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rays(scene, n: int, seed: int):
    """Seeded rays from inside and around the scene's box, in every
    direction: some hit behind their origin, some miss."""
    rng = np.random.default_rng(seed)
    v = scene.tri_v0[scene.tri_valid].numpy()
    lo, hi = v.min(axis=0), v.max(axis=0)
    o = rng.uniform(lo - 0.2 * (hi - lo), hi + 0.2 * (hi - lo), (n, 3))
    d = rng.normal(size=(n, 3))
    return o.astype(np.float32), d.astype(np.float32)


def _camera_rays(scene):
    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays

    o, d = make_primary_rays(scene.eye, scene.ortho, scene.meta.width,
                             scene.meta.height)
    return o.numpy(), d.numpy()


def _grazing(scene, o, d, idx) -> bool:
    """Whether ray (o, d) passes within GRAZING_MARGIN of an edge of row
    ``idx`` (a flipped winner's candidates)."""
    rows = [scene.tri_v0[idx], scene.tri_v1[idx], scene.tri_v2[idx]]
    return abs(bary_margin_f64(*(r.numpy() for r in rows), o, d)) \
        < GRAZING_MARGIN


def _scenes():
    return {
        "cornell": pack_pair(synthetic.cornell_box_scene(8, 8)),
        "field": pack_pair(synthetic.box_field_scene(n_boxes=12, width=8,
                                                     height=8)),
    }


@pytest.fixture(scope="module")
def scenes():
    return _scenes()


def test_intersect_reference_matches_jax():
    """Seeded rays against seeded triangles, broadcast [N, 1] x [1, T]:
    hits (backward ones included) and signed t."""
    rng = np.random.default_rng(0)
    n, t_count = 512, 24
    o = rng.uniform(-2, 2, (n, 1, 3)).astype(np.float32)
    d = rng.normal(size=(n, 1, 3)).astype(np.float32)
    tri = rng.uniform(-1.5, 1.5, (3, 1, t_count, 3)).astype(np.float32)
    hit, t = geo.intersect_reference(*(torch.from_numpy(a)
                                       for a in (o, d, *tri)))
    want_hit, want_t = (np.asarray(a) for a in jgeo.intersect_reference(
        o, d, *tri))
    assert hit.shape == (n, t_count)
    both = hit.numpy() & want_hit
    np.testing.assert_allclose(t.numpy()[both], want_t[both], rtol=T_RTOL,
                               atol=T_ATOL)
    backward = both & (want_t < 0)
    assert backward.sum() > 50, "the draw must hold backward hits"
    for i, j in zip(*np.nonzero(hit.numpy() != want_hit)):
        margin = bary_margin_f64(tri[0, 0, j], tri[1, 0, j], tri[2, 0, j],
                                 o[i, 0], d[i, 0])
        assert abs(margin) < GRAZING_MARGIN, (i, j, margin)


@pytest.mark.parametrize("mode", ["reference", "fast"])
@pytest.mark.parametrize("name", ["cornell", "field"])
def test_nearest_hit_matches_jax(scenes, name, mode):
    scene, ref = scenes[name]
    o1, d1 = _rays(scene, 1500, seed=1)
    o2, d2 = _camera_rays(scene)
    o, d = np.concatenate([o1, o2]), np.concatenate([d1, d2])
    got = geo.nearest_hit(torch.from_numpy(o), torch.from_numpy(d), scene,
                          mode=mode)
    want = jgeo.nearest_hit(o, d, ref, mode=mode)
    w = {f: np.asarray(getattr(want, f)) for f in want._fields}
    g = {f: getattr(got, f).numpy() for f in got._fields}
    assert g["tri_idx"].dtype == np.int32 and g["material"].dtype == np.int32
    same = (g["hit"] == w["hit"]) & (g["tri_idx"] == w["tri_idx"])
    for i in np.nonzero(~same)[0]:
        # a flipped winner grazes an edge, or ties within rounding with a
        # coplanar row (a cube's base on the floor): t within T_RTOL
        tied = g["hit"][i] and w["hit"][i] and np.isclose(
            g["t"][i], w["t"][i], rtol=T_RTOL, atol=T_ATOL)
        assert tied or _grazing(scene, o[i], d[i], g["tri_idx"][i]) \
            or _grazing(scene, o[i], d[i], w["tri_idx"][i]), i
    assert same.mean() > 0.99
    np.testing.assert_allclose(g["t"][same], w["t"][same], rtol=T_RTOL,
                               atol=T_ATOL)
    np.testing.assert_allclose(g["point"][same], w["point"][same],
                               rtol=T_RTOL, atol=1e-5)
    for f in ("normal", "material", "is_light"):
        np.testing.assert_array_equal(g[f][same], w[f][same])
    if mode == "reference":
        assert (g["hit"] & (g["t"] < 0)).sum() > 20, "backward winners"
    else:
        assert (g["t"][g["hit"]] > 1e-4).all()


@pytest.mark.parametrize("mode", ["reference", "fast"])
@pytest.mark.parametrize("name", ["cornell", "field"])
def test_any_hit_and_first_occluder_match_jax(scenes, name, mode):
    scene, ref = scenes[name]
    o, d = _rays(scene, 2000, seed=2)
    dist = np.random.default_rng(3).uniform(0.0, 8.0, o.shape[0]).astype(
        np.float32)
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(dist))
    occ = geo.any_hit_within(*args, scene, mode=mode).numpy()
    want_occ = np.asarray(jgeo.any_hit_within(o, d, dist, ref, mode=mode))
    assert occ.any() and not occ.all()
    if mode == "fast":
        # the first occluder's colour is reference-mode shading only
        assert (occ == want_occ).mean() > 0.995
        return
    idx, mat = (a.numpy() for a in geo.first_occluder_index(*args, scene))
    want_idx, want_mat = (np.asarray(a) for a in jgeo.first_occluder_index(
        o, d, dist, ref, mode=mode))
    same = (occ == want_occ) & (idx == want_idx)
    assert same.mean() > 0.995, same.mean()
    np.testing.assert_array_equal(occ, idx >= 0)
    np.testing.assert_array_equal(mat[same], want_mat[same])
    assert (mat[idx < 0] == 0).all()
    np.testing.assert_array_equal(
        mat[idx >= 0], scene.tri_material[idx[idx >= 0]].numpy())


def _two_planes_scene(swap: bool) -> SceneDescription:
    """Quads at z = -1 (object A) and z = +1 (object B), a light far off to
    the side; rays from z = 0 along -z meet A at t = 1 and B at t = -1:
    equal squared distance. ``swap`` puts B first in the buffer."""
    def quad(z, path):
        return mesh_from_arrays([[-1, -1, z], [1, -1, z], [1, 1, z],
                                 [-1, 1, z]], [[0, 1, 2], [0, 2, 3]],
                                path=path)

    a = SdlObject(mesh=quad(-1.0, "a"), rgb=(1, 0, 0), ka=0.1, kd=0.5,
                  ks=0.0, kt=0.0, n=1.0)
    b = SdlObject(mesh=quad(1.0, "b"), rgb=(0, 1, 0), ka=0.1, kd=0.5,
                  ks=0.0, kt=0.0, n=1.0)
    light = mesh_from_arrays([[5, 5, 5], [6, 5, 5], [5, 5, 6]], [[0, 1, 2]],
                             path="light")
    return SceneDescription(eye=(0, 0, 3), width=4, height=4,
                            ortho=(-1, -1, 1, 1), ambient=0.1,
                            light_mesh=light, light_color=(1, 1, 1),
                            objects=[b, a] if swap else [a, b])


@pytest.mark.parametrize("swap", [False, True])
def test_t_against_minus_t_tie_goes_to_the_first_row(swap):
    """In reference mode the key is t * t, so a hit at t = 1 ties with one
    at t = -1: the smaller buffer row wins in both packages (the
    reference's first-minimum ``min``); fast mode takes the forward hit."""
    scene, ref = pack_pair(_two_planes_scene(swap))
    rng = np.random.default_rng(4)
    o = np.concatenate([rng.uniform(-0.4, 0.4, (64, 2)),
                        np.zeros((64, 1))], axis=1).astype(np.float32)
    d = np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (64, 1))
    got = geo.nearest_hit(torch.from_numpy(o), torch.from_numpy(d), scene,
                          mode="reference")
    want = jgeo.nearest_hit(o, d, ref, mode="reference")
    np.testing.assert_array_equal(got.tri_idx.numpy(),
                                  np.asarray(want.tri_idx))
    assert got.hit.all()
    assert (got.tri_idx.numpy() <= 1).all(), "the first object's rows win"
    first_z = 1.0 if swap else -1.0
    np.testing.assert_allclose(got.t.numpy(), -first_z, atol=1e-6)
    np.testing.assert_allclose(got.point.numpy()[:, 2], first_z, atol=1e-6)
    fast = geo.nearest_hit(torch.from_numpy(o), torch.from_numpy(d), scene,
                           mode="fast")
    np.testing.assert_allclose(fast.point.numpy()[:, 2], -1.0, atol=1e-6)


def test_coplanar_duplicate_tie_goes_to_the_first_row(monkeypatch):
    """A triangle duplicated later in the buffer ties on t exactly: the
    first copy wins, within a tile and across tiles, in both packages."""
    desc = synthetic.box_field_scene(n_boxes=12, width=8, height=8)
    floor = desc.objects[0].mesh  # rows 0-1; the copy takes rows 2-3
    dup = mesh_from_arrays(np.concatenate([floor.vertices] * 2),
                           np.concatenate([floor.faces,
                                           floor.faces + len(floor.vertices)]),
                           path="floor2")
    desc.objects[0] = SdlObject(mesh=dup, rgb=(0.5, 0.5, 0.5), ka=0.3,
                                kd=0.7, ks=0.0, kt=0.0, n=1.0)
    scene, ref = pack_pair(desc)
    o, d = _camera_rays(scene)
    first_copy = np.arange(2)
    for mode in ("reference", "fast"):
        for tile in (128, 3):
            monkeypatch.setattr(geo, "TILE", tile)
            got = geo.nearest_hit(torch.from_numpy(o), torch.from_numpy(d),
                                  scene, mode=mode)
            on_floor = got.material.numpy() == 0
            assert on_floor.any()
            assert np.isin(got.tri_idx.numpy()[on_floor], first_copy).all()
        want = jgeo.nearest_hit(o, d, ref, mode=mode)
        np.testing.assert_array_equal(
            got.tri_idx.numpy()[on_floor],
            np.asarray(want.tri_idx)[on_floor])


@pytest.mark.parametrize("mode", ["reference", "fast"])
def test_tiles_and_chunks_change_no_bit(scenes, mode, monkeypatch):
    """The sweeps give the same bits at any tile width (ragged last tiles
    included) and any lane chunk."""
    scene, _ = scenes["field"]
    o, d = (torch.from_numpy(a) for a in _rays(scene, 700, seed=5))
    dist = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 8, 700).astype(np.float32))
    base = geo.nearest_hit(o, d, scene, mode=mode)
    base_occ = geo.any_hit_within(o, d, dist, scene, mode=mode)
    base_first = geo.first_occluder_index(o, d, dist, scene)
    assert base.hit.any() and base_occ.any()
    for tile, chunk in ((7, 64), (32, 5), (256, 700), (1000, 1), (128, 99)):
        monkeypatch.setattr(geo, "TILE", tile)
        monkeypatch.setattr(geo, "LANE_CHUNK", chunk)
        got = geo.nearest_hit(o, d, scene, mode=mode)
        for f in got._fields:
            assert torch.equal(getattr(got, f), getattr(base, f)), (f, tile)
        assert torch.equal(geo.any_hit_within(o, d, dist, scene, mode=mode),
                           base_occ)
        for a, b in zip(geo.first_occluder_index(o, d, dist, scene),
                        base_first):
            assert torch.equal(a, b)


def _aimed_rays(scene, rows, n: int, seed: int):
    """Seeded rays from around the scene aimed at the centroids of
    ``rows``, and each ray's distance to its target."""
    rng = np.random.default_rng(seed)
    o, _ = _rays(scene, n, seed)
    pick = rng.choice(rows, n)
    cent = ((scene.tri_v0 + scene.tri_v1 + scene.tri_v2) / 3.0).numpy()
    d = cent[pick] - o
    return o, d.astype(np.float32), np.linalg.norm(d, axis=1).astype(
        np.float32)


def test_ragged_last_tile_jax_misnames_rows():
    """JAX's sweep names a tile's rows from its unshifted start, but
    ``lax.dynamic_slice_in_dim`` shifts a last tile that overruns the
    buffer back: a box field of 148 triangles packed with pad_to=32 has 160
    rows, so JAX's second tile covers rows 32-159 and names row r as
    r + 96. Every lane whose winner (or first occluder) lies in rows
    128-159 gets a row past the buffer. The port's last tile is rows
    128-159, and its answer is JAX's one-tile answer (tile=160)."""
    scene, ref = pack_pair(synthetic.box_field_scene(n_boxes=12, width=12,
                                                     height=12), pad_to=32)
    assert scene.num_padded_triangles == 160
    n_real = scene.meta.n_triangles
    o, d, dist = _aimed_rays(scene, np.arange(100, n_real), 1500, seed=7)
    to = (torch.from_numpy(o), torch.from_numpy(d))
    for mode in ("reference", "fast"):
        got = geo.nearest_hit(*to, scene, mode=mode)
        one_tile = jgeo.nearest_hit(o, d, ref, mode=mode, tile=160)
        jax_tiled = jgeo.nearest_hit(o, d, ref, mode=mode)
        idx = got.tri_idx.numpy()
        same = idx == np.asarray(one_tile.tri_idx)
        assert same.mean() > 0.99
        late = same & got.hit.numpy() & (idx >= 128)
        assert late.sum() > 100, "rays must win on rows past 128"
        np.testing.assert_array_equal(np.asarray(jax_tiled.tri_idx)[late],
                                      idx[late] + 96)
        early = same & ~late
        np.testing.assert_array_equal(np.asarray(jax_tiled.tri_idx)[early],
                                      idx[early])
    # the first occluder of shadow rays past those rows
    o, d, dist = _aimed_rays(scene, np.arange(100, n_real - 2), 1500, seed=8)
    idx, _ = geo.first_occluder_index(torch.from_numpy(o),
                                      torch.from_numpy(d),
                                      torch.from_numpy(dist * 2.0), scene)
    want, _ = jgeo.first_occluder_index(o, d, dist * 2.0, ref, tile=160)
    tiled, _ = jgeo.first_occluder_index(o, d, dist * 2.0, ref)
    idx = idx.numpy()
    same = idx == np.asarray(want)
    assert same.mean() > 0.99
    late = same & (idx >= 128)
    assert late.sum() > 50
    np.testing.assert_array_equal(np.asarray(tiled)[late], idx[late] + 96)


def test_resolve_hit_attributes_gathers_rows(scenes):
    scene, _ = scenes["cornell"]
    idx = torch.tensor([0, 5, scene.meta.n_triangles - 1, 0],
                       dtype=torch.int32)
    found = torch.tensor([True, True, True, False])
    normal, material, is_light = geo.resolve_hit_attributes(scene, idx,
                                                            found)
    assert torch.equal(normal, scene.tri_normal[idx.long()])
    assert torch.equal(material, scene.tri_material[idx.long()])
    assert is_light.tolist() == [False, False, True, False]


def test_reference_route_of_the_component_major_sweeps(scenes):
    """``nearest_hit_cm`` and ``any_hit_within_cm`` with mode="reference"
    are the row-major reference sweeps, whatever ``accel`` says."""
    scene, _ = scenes["field"]
    o, d = (torch.from_numpy(a) for a in _rays(scene, 300, seed=8))
    dist = torch.full((300,), 3.0)
    row = geo.nearest_hit(o, d, scene, mode="reference")
    for accel in ("none", "sparse"):
        cm = geo.nearest_hit_cm(o.T, d.T, scene, accel=accel,
                                mode="reference")
        assert torch.equal(cm.tri_idx, row.tri_idx)
        assert torch.equal(cm.point3, row.point.T)
        occ = geo.any_hit_within_cm(o.T, geo.normalize3(d.T), dist, scene,
                                    accel=accel, mode="reference")
        assert torch.equal(occ, geo.any_hit_within(
            o, geo.normalize3(d.T).T, dist, scene, mode="reference"))


@pytest.mark.parametrize("mode", ["reference", "fast"])
def test_winner_t_gradient_matches_jax(scenes, mode):
    """With grad on, the winner's t carries the gradient JAX's sweep gives
    the winning pair (its value stays the sweep's bits), in the rays'
    directions and the vertices of the valid rows, within 1e-6 of the
    largest component. JAX's reference-mode gradient is NaN on the padding
    rows (degenerate triangles, 0 * inf in the unused tiles' backward); the
    port's is 0 there (ROADMAP.md queue C)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    scene, ref = scenes["cornell"]
    o, d = _camera_rays(scene)
    weights = np.arange(o.shape[0], dtype=np.float32)
    v0 = scene.tri_v0.clone().requires_grad_(True)
    dt = torch.from_numpy(d).requires_grad_(True)
    got = geo.nearest_hit(torch.from_numpy(o), dt,
                          dataclasses.replace(scene, tri_v0=v0), mode=mode)
    with torch.no_grad():
        plain = geo.nearest_hit(torch.from_numpy(o), torch.from_numpy(d),
                                scene, mode=mode)
    assert torch.equal(got.t.detach(), plain.t)
    (got.t * torch.from_numpy(weights)).sum().backward()

    def loss(v0_, d_):
        hit = jgeo.nearest_hit(o, d_, dataclasses.replace(ref, tri_v0=v0_),
                               mode=mode)
        return jnp.sum(hit.t * weights)

    want_v0, want_d = (np.asarray(g) for g in jax.grad(
        loss, argnums=(0, 1))(ref.tri_v0, jnp.asarray(d)))
    valid = scene.tri_valid.numpy()
    scale = np.abs(want_v0[valid]).max()
    np.testing.assert_allclose(v0.grad.numpy()[valid], want_v0[valid],
                               rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(dt.grad.numpy(), want_d, rtol=0,
                               atol=1e-6 * np.abs(want_d).max())
    assert (v0.grad.numpy()[~valid] == 0).all()
    if mode == "reference":
        assert np.isnan(want_v0[~valid]).all()
