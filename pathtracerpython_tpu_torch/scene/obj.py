"""Minimal wavefront-OBJ parser producing numpy SoA arrays.

Same contract as ``pathtracerpython_tpu/scene/obj.py``:
  - only ``v`` and ``f`` records are honored; other record types are skipped;
  - negative face indices are relative to the number of vertices read so far;
  - faces with more than 3 vertices are fan-triangulated from vertex 0;
  - per-triangle geometric normal = normalize(cross(v1-v0, v2-v0));
  - per-triangle area = |cross(v1-v0, v2-v0)| / 2;
  - comments: a line whose first non-space char is ``#`` is dropped; inline
    ``#`` truncates the line; tabs become spaces.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def strip_comments(lines: list[str]) -> list[str]:
    """Comment/whitespace normalization with reference semantics."""
    out = []
    for line in lines:
        line = line.lstrip(" ")
        if not line or line.startswith("#"):
            continue
        if "#" in line:
            line = line.split("#", 1)[0]
        line = line.replace("\n", "").replace("\t", " ")
        out.append(line)
    return out


@dataclasses.dataclass
class ObjMesh:
    """A triangulated mesh as SoA numpy arrays.

    ``vertices``  — float64 [V, 3]
    ``faces``     — int32   [T, 3]  (indices into vertices)
    ``normals``   — float64 [T, 3]  (geometric, from winding)
    ``areas``     — float64 [T]
    """

    vertices: np.ndarray
    faces: np.ndarray
    normals: np.ndarray
    areas: np.ndarray
    path: str = ""

    @property
    def num_triangles(self) -> int:
        return int(self.faces.shape[0])

    def triangle_vertices(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Return (v0, v1, v2) each [T, 3]."""
        tri = self.vertices[self.faces]  # [T, 3, 3]
        return tri[:, 0], tri[:, 1], tri[:, 2]


def mesh_from_arrays(vertices, faces, path: str = "") -> ObjMesh:
    """Build an ObjMesh from raw vertex/face arrays with the same derived
    normals/areas the parser computes."""
    verts = np.asarray(vertices, dtype=np.float64).reshape(-1, 3)
    face_arr = np.asarray(faces, dtype=np.int32).reshape(-1, 3)
    tri = verts[face_arr]
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    cross = np.cross(e1, e2)
    norm = np.linalg.norm(cross, axis=-1, keepdims=True)
    normals = cross / np.where(norm == 0.0, 1.0, norm)
    areas = norm[:, 0] / 2.0
    return ObjMesh(
        vertices=verts, faces=face_arr, normals=normals, areas=areas, path=path
    )


def _triangulate(face: list[int]) -> list[tuple[int, int, int]]:
    if len(face) > 3:
        return [(face[0], face[i], face[i + 1]) for i in range(1, len(face) - 1)]
    return [tuple(face)]


def load_obj(path: str) -> ObjMesh:
    with open(path, "r") as f:
        lines = strip_comments(f.readlines())

    vertices: list[list[float]] = []
    faces: list[tuple[int, int, int]] = []
    for line in lines:
        tokens = [t for t in line.split(" ") if t not in ("", " ")]
        if not tokens:
            continue
        cmd, args = tokens[0], tokens[1:]
        if cmd == "v":
            vertices.append([float(x) for x in args[:3]])
        elif cmd == "f":
            idx = []
            for tok in args:
                # "f v/vt/vn" forms: keep the vertex index only.
                i = int(tok.split("/")[0])
                idx.append(len(vertices) + i if i < 0 else i - 1)
            faces.extend(_triangulate(idx))
        # other records are skipped, as in the reference

    return mesh_from_arrays(vertices, faces, path=path)
