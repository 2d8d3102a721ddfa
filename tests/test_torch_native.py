"""The port's native OBJ loader (``scene/native.py``, its own build of
``native/objparse.cpp``) against its Python parser on written OBJ files:
the cases of ``tests/test_native.py`` that need no reference checkout
(quirks, a missing file, malformed numbers, index 0, the morton sort), the
fallback when the library cannot be built, and the SDL loader's use of it.

Tolerances: vertices, faces and the morton permutation are exact; normals
and areas, derived from the same float64 vertices by the same numpy code,
are held to 1e-12 as the JAX tests hold them."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from pathtracerpython_tpu_torch.scene import native
from pathtracerpython_tpu_torch.scene.arrays import _morton_argsort, load_scene
from pathtracerpython_tpu_torch.scene.obj import load_obj
from pathtracerpython_tpu_torch.scene.synthetic import (
    box_field_scene,
    cornell_box_scene,
    write_obj,
    write_sdl,
)
from torch_parity import port_leaves

needs_native = pytest.mark.skipif(
    not native.native_available(),
    reason="no C++ compiler to build the native loader")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: with one intra-op thread these tests take
    the same time alone and do not fight the other test workers for cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _same_mesh(a, b):
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.faces, b.faces)
    np.testing.assert_allclose(a.normals, b.normals, atol=1e-12)
    np.testing.assert_allclose(a.areas, b.areas, atol=1e-12)


def test_library_is_the_ports_own():
    """Built from native/objparse.cpp into build/native/, never the JAX
    package's library in native/."""
    path = native.library_path()
    assert "/build/native/" in path and "libptt_native_" in path
    assert native.SOURCE.endswith("native/objparse.cpp")


@needs_native
def test_written_meshes_parse_alike(tmp_path):
    desc = box_field_scene(n_boxes=40, width=4, height=4)
    for i, mesh in enumerate([o.mesh for o in desc.objects]
                             + [desc.light_mesh]):
        path = str(tmp_path / f"m{i}.obj")
        write_obj(mesh, path)
        nat, py = native.load_obj_native(path), load_obj(path)
        _same_mesh(nat, py)
        np.testing.assert_array_equal(nat.vertices, mesh.vertices)
        np.testing.assert_array_equal(nat.faces, mesh.faces)


@needs_native
def test_native_obj_quirks(tmp_path):
    """Negative indices, fan triangulation, v/vt/vn forms, comments."""
    p = str(tmp_path / "t.obj")
    with open(p, "w") as f:
        f.write("# comment\n"
                "v 0 0 0\n"
                "v 1 0 0\n"
                "v 1 1 0  # inline comment\n"
                "v 0 1 0\n"
                "vn 0 0 1\n"
                "f 1/1/1 2/2/1 3/3/1 4/4/1\n"
                "f -4 -3 -2\n")
    nat, py = native.load_obj_native(p), load_obj(p)
    _same_mesh(nat, py)
    assert nat.faces.shape == (3, 3)  # the quad split in a fan, one tri


@needs_native
def test_native_zero_index_like_python(tmp_path):
    """'f 0' stores -1 as the Python parser does (numpy wraps it to the
    last vertex when it is used)."""
    p = str(tmp_path / "z.obj")
    with open(p, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 0 1 2\n")
    _same_mesh(native.load_obj_native(p), load_obj(p))


@needs_native
def test_native_missing_file_error():
    with pytest.raises(RuntimeError, match="cannot open"):
        native.load_obj_native("/nope/missing.obj")


@needs_native
def test_native_rejects_malformed_like_python(tmp_path):
    p = str(tmp_path / "bad.obj")
    with open(p, "w") as f:
        f.write("v 1,5 2 3\nv 0 0 0\nv 1 0 0\nf 1 2 3\n")
    with pytest.raises(RuntimeError, match="malformed"):
        native.load_obj_native(p)
    with pytest.raises(ValueError):
        load_obj(p)


@needs_native
@pytest.mark.parametrize("span", ["uniform", "degenerate"])
def test_native_morton_matches_python(span):
    rng = np.random.default_rng(0 if span == "uniform" else 3)
    pts = rng.uniform(-5, 5, (4096, 3))
    if span == "degenerate":
        pts[:, 2] = 1.0 + rng.uniform(0, 5e-13, 4096)  # span <= 1e-12
    np.testing.assert_array_equal(native.morton_argsort_native(pts),
                                  _morton_argsort(pts))


def test_fast_loader_always_works(tmp_path):
    p = str(tmp_path / "s.obj")
    with open(p, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    assert native.load_obj_fast(p).num_triangles == 1


def test_fallback_when_the_library_cannot_build(tmp_path, monkeypatch):
    """No compiler and no library: a warning, then the Python parser."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", False)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "nobuild"))
    monkeypatch.setattr(native, "_compiler", lambda: None)
    p = str(tmp_path / "s.obj")
    with open(p, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert not native.native_available()
        mesh = native.load_obj_fast(p)
    assert mesh.num_triangles == 1
    assert any("Python parser" in str(w.message) for w in caught)
    with pytest.raises(OSError):
        native.load_obj_native(p)


def test_sdl_packs_alike_with_either_parser(tmp_path, monkeypatch):
    """``load_scene`` reads OBJs through ``load_obj_fast``: the packed
    leaves are the same with the native parser and the Python one, and
    those of ``pack_scene`` on the description written."""
    from pathtracerpython_tpu_torch.scene import sdl
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene

    desc = dataclasses.replace(cornell_box_scene(8, 8), npaths=4, seed=3,
                               tonemapping=2.2)
    path = write_sdl(desc, str(tmp_path / "scene"))
    fast = port_leaves(load_scene(path, device="cpu"))
    monkeypatch.setattr(sdl, "load_obj", load_obj)
    slow = load_scene(path, device="cpu")
    assert (slow.meta.npaths, slow.meta.seed, slow.meta.tonemapping) == (
        4, 3, 2.2)
    want = port_leaves(pack_scene(desc, device="cpu"))
    for f, v in port_leaves(slow).items():
        np.testing.assert_array_equal(fast[f], v)
        np.testing.assert_array_equal(want[f], v)
