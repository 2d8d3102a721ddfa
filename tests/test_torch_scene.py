"""Scene parsing and packing of the PyTorch port against the JAX package:
the same SDL + OBJ files parse to the same description, and the same
description packs to equal leaves (bit for bit, same dtypes)."""

import dataclasses

import numpy as np
import pytest
import torch

from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu.scene import sdl as jax_sdl
from pathtracerpython_tpu_torch.kernels.intersect import nearest_t_idx_cm
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.ops.geometry import normalize3
from pathtracerpython_tpu_torch.scene import arrays, load_sdl, synthetic
from torch_parity import jax_leaves, port_leaves, to_jax_desc

_OBJ_A = """# a quad written as one face, with texture/normal indices
v 0 0 0
v 1 0 0
v\t1 1 0
v 0 1 0   # trailing comment
vt 0 0
f 1/1/1 2/1/1 3/1/1 4/1/1
"""

_OBJ_B = """v -1 -1 -2
v 1 -1 -2
v 0 1 -2
v 0 0 -3
f -4 -3 -2
f 1 2 4
o ignored record
"""

_OBJ_LIGHT = """v -0.5 2 -1
v 0.5 2 -1
v 0.5 2 -0.5
v -0.5 2 -0.5
f 1 2 3 4
"""

_SDL = """# tiny scene
eye 0.0 0.0 5.7
size 24 16
ortho -1 -1 1 1
background 0.1 0.2 0.3
ambient 0.5
light light.obj 1.0 0.9 0.8
npaths 10
tonemapping 2.2
seed 9
object a.obj 1.0 0.0 0.0 0.3 0.7 0 0 5
object b.obj 0.2 0.4 0.6 0.2 0.6 0.4 0.1 12
output out.pnm
unknown record here
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: with one intra-op thread these tests take
    the same time alone and do not fight the other test workers for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def sdl_path(tmp_path):
    for name, text in (("a.obj", _OBJ_A), ("b.obj", _OBJ_B),
                       ("light.obj", _OBJ_LIGHT), ("scene.sdl", _SDL)):
        (tmp_path / name).write_text(text)
    return str(tmp_path / "scene.sdl")


def _assert_mesh_equal(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    np.testing.assert_array_equal(a.normals, b.normals)
    np.testing.assert_array_equal(a.areas, b.areas)
    assert a.faces.dtype == b.faces.dtype


def test_sdl_and_obj_parse_like_jax(sdl_path):
    port = load_sdl(sdl_path)
    ref = jax_sdl.load_sdl(sdl_path)
    for f in ("eye", "width", "height", "ortho", "background", "ambient",
              "light_color", "npaths", "tonemapping", "seed", "output",
              "path"):
        assert getattr(port, f) == getattr(ref, f), f
    _assert_mesh_equal(port.light_mesh, ref.light_mesh)
    assert len(port.objects) == len(ref.objects) == 2
    for po, ro in zip(port.objects, ref.objects):
        assert (po.rgb, po.ka, po.kd, po.ks, po.kt, po.n) == (
            ro.rgb, ro.ka, ro.kd, ro.ks, ro.kt, ro.n)
        _assert_mesh_equal(po.mesh, ro.mesh)
    # the quad face fans into two triangles; negative indices resolve
    assert port.objects[0].mesh.num_triangles == 2
    np.testing.assert_array_equal(port.objects[1].mesh.faces[0], [0, 1, 2])


@pytest.mark.parametrize("order", ["none", "median"])
def test_load_scene_equals_jax(sdl_path, order):
    port = arrays.load_scene(sdl_path, pad_to=32, tri_order=order,
                             device="cpu")
    ref = jax_arrays.load_scene(sdl_path, pad_to=32, tri_order=order)
    got, want = port_leaves(port), jax_leaves(ref)
    for f in arrays.DATA_FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert dataclasses.asdict(port.meta) == dataclasses.asdict(ref.meta)


def _descs():
    return {
        "cornell": (synthetic.cornell_box_scene(16, 16), 32),
        "boxfield8": (synthetic.box_field_scene(n_boxes=8), 128),
    }


SCENES = ["cornell", "boxfield8"]
ORDERS = ["none", "morton", "median"]


@pytest.mark.parametrize("order", ORDERS)
@pytest.mark.parametrize("name", SCENES)
def test_pack_scene_leaves_equal_jax(name, order):
    desc, pad_to = _descs()[name]
    port = arrays.pack_scene(desc, pad_to=pad_to, tri_order=order,
                             device="cpu")
    ref = jax_arrays.pack_scene(to_jax_desc(desc), pad_to=pad_to,
                                tri_order=order)
    got, want = port_leaves(port), jax_leaves(ref)
    for f in arrays.DATA_FIELDS:
        assert got[f].dtype == want[f].dtype, f
        assert got[f].shape == want[f].shape, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert dataclasses.asdict(port.meta) == dataclasses.asdict(ref.meta)


@pytest.mark.parametrize("name", SCENES)
def test_from_jax_scene_reproduces_leaves(name):
    desc, pad_to = _descs()[name]
    ref = jax_arrays.pack_scene(to_jax_desc(desc), pad_to=pad_to,
                                tri_order="morton")
    port = arrays.from_jax_scene(jax_leaves(ref), ref.meta, device="cpu")
    got, want = port_leaves(port), jax_leaves(ref)
    for f in arrays.DATA_FIELDS:
        assert got[f].dtype == want[f].dtype, f
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    assert port.meta.n_triangles == ref.meta.n_triangles


def test_from_jax_scene_rejects_missing_fields():
    desc, pad_to = _descs()["cornell"]
    ref = jax_arrays.pack_scene(to_jax_desc(desc), pad_to=pad_to)
    leaves = jax_leaves(ref)
    del leaves["light_area"]
    with pytest.raises(ValueError, match="light_area"):
        arrays.from_jax_scene(leaves, ref.meta, device="cpu")


def test_pack_scene_rejects_incomplete_descriptions():
    desc = synthetic.cornell_box_scene(8, 8)
    with pytest.raises(ValueError, match="no light"):
        arrays.pack_scene(dataclasses.replace(desc, light_mesh=None),
                          device="cpu")
    with pytest.raises(ValueError, match="no objects"):
        arrays.pack_scene(dataclasses.replace(desc, objects=[]), device="cpu")
    with pytest.raises(ValueError, match="tri_order"):
        arrays.pack_scene(desc, tri_order="hilbert", device="cpu")


def test_constructors_default_to_the_card_and_never_fall_back(sdl_path):
    """Without ``device`` a scene is built on the card; where there is none
    the constructors raise and say how to ask for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default builds on it")
    desc = synthetic.cornell_box_scene(8, 8)
    ref = jax_arrays.pack_scene(to_jax_desc(desc), pad_to=32)
    calls = [
        lambda **kw: arrays.pack_scene(desc, pad_to=32, **kw),
        lambda **kw: arrays.load_scene(sdl_path, pad_to=32, **kw),
        lambda **kw: arrays.from_jax_scene(jax_leaves(ref), ref.meta, **kw),
        lambda **kw: arrays.from_numpy_leaves(
            jax_leaves(ref), arrays.pack_scene(desc, pad_to=32,
                                               device="cpu").meta, **kw),
    ]
    for build in calls:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()
        for device in ("cpu", torch.device("cpu")):
            assert build(device=device).device == torch.device("cpu")


def test_scene_to_device_moves_every_leaf():
    scene = arrays.pack_scene(synthetic.cornell_box_scene(8, 8), pad_to=32,
                              device="cpu")
    moved = scene.to(torch.device("cpu"))
    assert moved.meta == scene.meta
    assert moved.device == torch.device("cpu")
    for f in arrays.DATA_FIELDS:
        assert torch.equal(getattr(moved, f), getattr(scene, f)), f


def test_cornell_stand_in_layout():
    desc = synthetic.cornell_box_scene(40, 40)
    scene = arrays.pack_scene(desc, pad_to=32, device="cpu")
    assert scene.meta.n_triangles == 36
    assert scene.meta.n_light_triangles == 2
    assert int(scene.tri_occluder.sum()) == 34
    assert scene.num_padded_triangles == 64
    assert [o.ks for o in desc.objects] == [0.0] * 5 + [0.9, 0.6]
    np.testing.assert_array_equal(scene.mat_rgb[0].numpy(), [1, 0, 0])
    np.testing.assert_array_equal(scene.mat_rgb[1].numpy(), [0, 1, 0])
    # the room fills the view: every primary ray hits something
    o, d = make_primary_rays(scene.eye, scene.ortho, 40, 40)
    _, idx = nearest_t_idx_cm(o.T.contiguous(), normalize3(d.T.contiguous()),
                              scene)
    assert bool((idx >= 0).all())
