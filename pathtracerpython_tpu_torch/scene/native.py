"""ctypes bindings for the native (C++) OBJ loader, as the JAX package's
``scene/native.py``.

``native/objparse.cpp`` reimplements the Python OBJ parser's semantics at
C++ speed for large meshes (identical on well-formed files; ``strtod``
rejects a few exotic numeric forms Python ``float()`` accepts, which then
raise here instead). The port builds its own copy of the library from
that source with the host C++ compiler, at first use, into
``build/native/`` beside the package (named by a hash of the source and
flags, so a changed source rebuilds); it never writes into ``native/`` and
never loads the JAX package's library. Where the library cannot be built
or loaded, a warning says so and ``load_obj_fast`` falls back to the
Python parser: this is a parser, not a device path. Importing this module
runs nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings

import numpy as np

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_DIR = os.path.dirname(_PACKAGE_DIR)
SOURCE = os.path.join(_REPO_DIR, "native", "objparse.cpp")
BUILD_DIR = os.path.join(_REPO_DIR, "build", "native")
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib = None
_lib_tried = False


def _compiler() -> str | None:
    for name in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        path = shutil.which(name) if name else None
        if path:
            return path
    return None


def library_path() -> str:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libptt_native_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile ``native/objparse.cpp`` unless the library for it exists;
    return its path. Raises ``RuntimeError`` when it cannot."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler ($CXX, c++, g++, clang++)")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed with exit code {proc.returncode}:"
                           f"\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load_library():
    global _lib, _lib_tried
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        try:
            lib = ctypes.CDLL(build())
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            warnings.warn(f"native OBJ loader unavailable ({e}); using the "
                          "Python parser")
            return None
        lib.obj_parse.restype = ctypes.c_int
        lib.obj_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_char_p,
            ctypes.c_int64,
        ]
        lib.obj_buffers_free.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.morton_argsort.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native library is built and loaded (building it on the
    first call)."""
    return _load_library() is not None


def load_obj_native(path: str):
    """Parse an OBJ with the native loader; returns an ``ObjMesh``. Raises
    ``RuntimeError`` on parse errors and ``OSError`` when the library is
    unavailable (``load_obj_fast`` falls back instead)."""
    from pathtracerpython_tpu_torch.scene.obj import mesh_from_arrays

    lib = _load_library()
    if lib is None:
        raise OSError("native OBJ loader unavailable")
    verts_p = ctypes.POINTER(ctypes.c_double)()
    faces_p = ctypes.POINTER(ctypes.c_int32)()
    n_verts = ctypes.c_int64()
    n_faces = ctypes.c_int64()
    err = ctypes.create_string_buffer(512)
    rc = lib.obj_parse(
        path.encode(), ctypes.byref(verts_p), ctypes.byref(n_verts),
        ctypes.byref(faces_p), ctypes.byref(n_faces), err, len(err),
    )
    if rc != 0:
        raise RuntimeError(err.value.decode())
    try:
        nv, nf = n_verts.value, n_faces.value
        verts = (np.ctypeslib.as_array(verts_p, shape=(nv, 3)).copy()
                 if nv else np.zeros((0, 3)))
        faces = (np.ctypeslib.as_array(faces_p, shape=(nf, 3)).copy()
                 if nf else np.zeros((0, 3), np.int32))
    finally:
        lib.obj_buffers_free(verts_p, faces_p)
    return mesh_from_arrays(verts, faces, path=path)


def load_obj_fast(path: str):
    """The native OBJ parse where the library is available, the Python
    parser otherwise."""
    from pathtracerpython_tpu_torch.scene.obj import load_obj

    if native_available():
        return load_obj_native(path)
    return load_obj(path)


def morton_argsort_native(points: np.ndarray) -> np.ndarray:
    """Native Z-order argsort of [N, 3] points: the permutation of
    ``scene.arrays._morton_argsort``."""
    lib = _load_library()
    if lib is None:
        raise OSError("native OBJ loader unavailable")
    pts = np.ascontiguousarray(points, dtype=np.float64)
    out = np.empty(pts.shape[0], dtype=np.int64)
    lib.morton_argsort(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        pts.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out
