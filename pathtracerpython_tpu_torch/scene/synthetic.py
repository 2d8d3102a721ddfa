"""Procedural scenes built as ``SceneDescription``s, so they flow through
the same packing and render path as parsed SDL files.

``box_mesh``, ``quad_mesh`` and ``box_field_scene`` match
``pathtracerpython_tpu/scene/synthetic.py`` exactly (same seeds, same
vertices). ``cornell_box_scene`` builds a Cornell box after the layout of
the reference's ``objs/cornellroom.sdl`` from these primitives, so tests
and the on-card smoke run need no file outside the repository.
``flat_scene`` is the floor-and-light scene of the JAX package's gradient
tests, ``occluder_scene`` the floor, blocker and light of its soft-visibility
tests (``tests/test_boundary.py:make_occluder_scene``). ``write_sdl``
writes any of them out as an SDL file with its OBJ files, for the CLI.
"""

from __future__ import annotations

import os

import numpy as np

from pathtracerpython_tpu_torch.scene.obj import ObjMesh, mesh_from_arrays
from pathtracerpython_tpu_torch.scene.sdl import SceneDescription, SdlObject

_BOX_FACES = np.asarray(
    [
        [0, 1, 2], [0, 2, 3],  # bottom (y-)
        [4, 6, 5], [4, 7, 6],  # top (y+)
        [0, 4, 5], [0, 5, 1],  # z-
        [3, 2, 6], [3, 6, 7],  # z+
        [1, 5, 6], [1, 6, 2],  # x+
        [0, 3, 7], [0, 7, 4],  # x-
    ],
    dtype=np.int32,
)


def box_mesh(center, half, path: str = "box") -> ObjMesh:
    """12-triangle axis-aligned box."""
    c = np.asarray(center, np.float64)
    h = np.asarray(half, np.float64)
    corners = np.asarray(
        [
            [-1, -1, -1], [1, -1, -1], [1, -1, 1], [-1, -1, 1],
            [-1, 1, -1], [1, 1, -1], [1, 1, 1], [-1, 1, 1],
        ],
        np.float64,
    )
    return mesh_from_arrays(c + corners * h, _BOX_FACES, path=path)


def quad_mesh(p0, p1, p2, p3, path: str = "quad") -> ObjMesh:
    return mesh_from_arrays(
        np.asarray([p0, p1, p2, p3], np.float64),
        np.asarray([[0, 1, 2], [0, 2, 3]], np.int32),
        path=path,
    )


def grid_light(nx: int, nz: int, y: float, x0: float, x1: float, z0: float,
               z1: float, path: str = "grid_light") -> ObjMesh:
    """A flat light of nx * nz quads (2 * nx * nz triangles) at height y
    over [x0, x1] x [z0, z1], facing -y: a light mesh too large for the
    fused NEE (more than 64 triangles) when nx * nz > 32."""
    xs = np.linspace(x0, x1, nx + 1)
    zs = np.linspace(z0, z1, nz + 1)
    verts = [[x, y, z] for z in zs for x in xs]
    faces = []
    for j in range(nz):
        for i in range(nx):
            a = j * (nx + 1) + i
            b, c, d = a + 1, a + nx + 2, a + nx + 1
            faces += [[a, b, c], [a, c, d]]
    return mesh_from_arrays(verts, faces, path=path)


def box_field_scene(
    n_boxes: int = 64,
    extent: float = 8.0,
    seed: int = 0,
    width: int = 64,
    height: int = 64,
) -> SceneDescription:
    """A floor, a ceiling light, and ``n_boxes`` jittered boxes
    (12 triangles each) — ``12 * n_boxes + 4`` triangles in total.

    One SDL object holds all boxes (one shared material), so the triangle
    count scales without growing the material table.
    """
    rng = np.random.default_rng(seed)
    e = extent

    centers = rng.uniform([-e, -0.8, -2 * e], [e, 0.8, -0.5], (n_boxes, 3))
    halves = rng.uniform(0.05, 0.25, (n_boxes, 3))

    verts, faces = [], []
    off = 0
    for c, h in zip(centers, halves):
        m = box_mesh(c, h)
        verts.append(m.vertices)
        faces.append(m.faces + off)
        off += m.vertices.shape[0]
    boxes = mesh_from_arrays(
        np.concatenate(verts), np.concatenate(faces), path="boxes"
    )

    floor = quad_mesh(
        [-e, -1.0, 0.5], [e, -1.0, 0.5], [e, -1.0, -2 * e],
        [-e, -1.0, -2 * e], path="floor",
    )
    light = quad_mesh(
        [-0.6, 1.4, -e], [0.6, 1.4, -e], [0.6, 1.4, -e + 1.2],
        [-0.6, 1.4, -e + 1.2], path="light",
    )

    return SceneDescription(
        eye=(0.0, 0.0, 3.0),
        width=width,
        height=height,
        ortho=(-1.0, -1.0, 1.0, 1.0),
        ambient=0.4,
        light_mesh=light,
        light_color=(1.0, 1.0, 1.0),
        objects=[
            SdlObject(mesh=floor, rgb=(0.7, 0.7, 0.7), ka=0.4, kd=0.6,
                      ks=0.0, kt=0.0, n=1.0),
            SdlObject(mesh=boxes, rgb=(0.6, 0.45, 0.3), ka=0.3, kd=0.7,
                      ks=0.0, kt=0.0, n=1.0),
        ],
        path=f"synthetic://box_field(n={n_boxes},seed={seed})",
    )


# Room half-extents and depth of the reference Cornell room: walls at
# x = ±3.822, floor and ceiling at y = ±3.8416, back wall at z = -32.76.
_ROOM_X = 3.822
_ROOM_Y = 3.8416
_ROOM_Z = -32.76
# The light hangs 0.84 below the ceiling (the reference's sits 0.0056 below
# it). Shadow rays from the ceiling then leave it at a clear angle: with a
# near-grazing angle, the computed t of the ceiling's own plane is noise of
# the size of the 1e-4 near-clip, and a hit point one ulp off the plane
# flips whether the ray counts as occluded.
_LIGHT_Y = 3.0


def cornell_box_scene(width: int = 40, height: int = 40) -> SceneDescription:
    """A Cornell box in the reference scene's layout: five wall quads
    (red left, green right, white floor, ceiling and back), a tall cube
    with ks=0.9 and a short cube with ks=0.6 (kd=0.7, n=5, so the specular
    branch runs), and a 2-triangle white light under the ceiling. Eye
    (0, 0, 5.7), ortho (-1, -1, 1, 1), ambient 0.5; the room fills the
    whole view, so no primary ray misses. 36 triangles, 34 of them
    occluders.
    """
    x, y, z = _ROOM_X, _ROOM_Y, _ROOM_Z
    # windings give inward-facing normals (the back wall faces +z)
    left = quad_mesh([-x, -y, 0], [-x, -y, z], [-x, y, z], [-x, y, 0],
                     path="leftwall")
    right = quad_mesh([x, -y, z], [x, -y, 0], [x, y, 0], [x, y, z],
                      path="rightwall")
    floor = quad_mesh([-x, -y, 0], [x, -y, 0], [x, -y, z], [-x, -y, z],
                      path="floor")
    ceiling = quad_mesh([-x, y, z], [x, y, z], [x, y, 0], [-x, y, 0],
                        path="ceiling")
    back = quad_mesh([-x, -y, z], [x, -y, z], [x, y, z], [-x, y, z],
                     path="back")
    tall = box_mesh([-1.6, -y + 2.2, -26.0], [1.0, 2.2, 1.0], path="cube1")
    short = box_mesh([1.6, -y + 1.0, -21.0], [1.0, 1.0, 1.0], path="cube2")
    # no face plane of the cubes passes within 0.15 of the light, so no
    # shadow ray grazes the face its shading point lies on
    light = quad_mesh(
        [-0.45, _LIGHT_Y, -24.3], [0.45, _LIGHT_Y, -24.3],
        [0.45, _LIGHT_Y, -22.5], [-0.45, _LIGHT_Y, -22.5], path="light",
    )

    def wall(mesh, rgb):
        return SdlObject(mesh=mesh, rgb=rgb, ka=0.3, kd=0.7, ks=0.0, kt=0.0,
                         n=5.0)

    def cube(mesh, ks):
        return SdlObject(mesh=mesh, rgb=(1.0, 1.0, 1.0), ka=0.3, kd=0.7,
                         ks=ks, kt=0.0, n=5.0)

    white = (1.0, 1.0, 1.0)
    return SceneDescription(
        eye=(0.0, 0.0, 5.7),
        width=width,
        height=height,
        ortho=(-1.0, -1.0, 1.0, 1.0),
        background=(0.0, 0.0, 0.0),
        ambient=0.5,
        light_mesh=light,
        light_color=(1.0, 1.0, 1.0),
        objects=[
            wall(left, (1.0, 0.0, 0.0)),
            wall(right, (0.0, 1.0, 0.0)),
            wall(floor, white),
            wall(ceiling, white),
            wall(back, white),
            cube(tall, 0.9),
            cube(short, 0.6),
        ],
        path="synthetic://cornell_box",
    )


def flat_scene(width: int = 16, height: int = 16) -> SceneDescription:
    """One big diffuse floor triangle and one light triangle above it, the
    scene of the JAX package's gradient tests (``tests/test_diff.py``):
    no occluder and no silhouette edge near the floor's interior, so the
    radiance there is a smooth function of every parameter. Eye (0, 0, 3),
    ortho (-1, -1, 1, 1), ambient 0.4."""
    floor = mesh_from_arrays(
        [[-5.0, -1.0, 1.0], [5.0, -1.0, 1.0], [0.0, -1.0, -9.0]],
        [[0, 1, 2]], path="floor",
    )
    light = mesh_from_arrays(
        [[-0.5, 1.5, -2.5], [0.5, 1.5, -2.5], [0.0, 1.5, -1.5]],
        [[0, 1, 2]], path="light",
    )
    return SceneDescription(
        eye=(0.0, 0.0, 3.0),
        width=width,
        height=height,
        ortho=(-1.0, -1.0, 1.0, 1.0),
        ambient=0.4,
        light_mesh=light,
        light_color=(1.0, 0.9, 0.8),
        objects=[
            SdlObject(mesh=floor, rgb=(0.6, 0.4, 0.2), ka=0.3, kd=0.7,
                      ks=0.0, kt=0.0, n=2.0)
        ],
        path="synthetic://flat",
    )


def occluder_scene(width: int = 12, height: int = 12) -> SceneDescription:
    """A floor, an overhead light and a small opaque blocker quad (material
    row 1) between them, the scene of the JAX package's soft-visibility
    tests: the blocker shadows part of the floor, and its silhouette covers
    part of the floor seen from the camera, so one scene holds both
    boundary terms. Eye (0, 0.8, 3), ortho (-1, -1, 1, 1), ambient 0.3."""
    floor = quad_mesh([-4.0, -1.0, 2.0], [4.0, -1.0, 2.0],
                      [4.0, -1.0, -8.0], [-4.0, -1.0, -8.0], path="floor")
    blocker = quad_mesh([-0.4, 0.0, -2.4], [0.4, 0.0, -2.4],
                        [0.4, 0.0, -1.6], [-0.4, 0.0, -1.6], path="blocker")
    light = quad_mesh([-0.7, 1.5, -2.7], [0.7, 1.5, -2.7], [0.7, 1.5, -1.3],
                      [-0.7, 1.5, -1.3], path="light")
    return SceneDescription(
        eye=(0.0, 0.8, 3.0),
        width=width,
        height=height,
        ortho=(-1.0, -1.0, 1.0, 1.0),
        ambient=0.3,
        light_mesh=light,
        light_color=(1.0, 1.0, 1.0),
        objects=[
            SdlObject(mesh=floor, rgb=(0.7, 0.7, 0.7), ka=0.3, kd=0.7,
                      ks=0.0, kt=0.0, n=1.0),
            SdlObject(mesh=blocker, rgb=(0.8, 0.2, 0.2), ka=0.3, kd=0.7,
                      ks=0.0, kt=0.0, n=1.0),
        ],
        path="synthetic://occluder",
    )


def _num(x) -> str:
    """A float as the shortest text that parses back to the same float64."""
    return repr(float(x))


def write_obj(mesh: ObjMesh, path: str) -> None:
    """An OBJ of ``mesh``'s vertices and triangles (1-based ``f`` records),
    with every coordinate written to round-trip exactly."""
    lines = [f"v {_num(x)} {_num(y)} {_num(z)}" for x, y, z in mesh.vertices]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in mesh.faces]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def write_sdl(desc: SceneDescription, directory: str,
              name: str = "scene.sdl") -> str:
    """Write ``desc`` as ``directory/name`` with one OBJ file per mesh
    beside it, so that ``load_scene`` of the file, in this package or the
    JAX one, packs the same leaves as ``pack_scene(desc)``. Returns the SDL
    path. Records: eye, size, ortho, background, ambient, light, the
    optional npaths, tonemapping and seed, and one ``object`` per SDL
    object, in order."""
    os.makedirs(directory, exist_ok=True)

    def obj_file(mesh: ObjMesh, stem: str) -> str:
        file = f"{stem}.obj"
        write_obj(mesh, os.path.join(directory, file))
        return file

    nums = lambda values: " ".join(_num(v) for v in values)  # noqa: E731
    lines = [f"eye {nums(desc.eye)}", f"size {desc.width} {desc.height}",
             f"ortho {nums(desc.ortho)}"]
    if desc.background is not None:
        lines.append(f"background {nums(desc.background)}")
    if desc.ambient is not None:
        lines.append(f"ambient {_num(desc.ambient)}")
    lines.append(f"light {obj_file(desc.light_mesh, 'light')} "
                 f"{nums(desc.light_color)}")
    if desc.npaths is not None:
        lines.append(f"npaths {desc.npaths}")
    if desc.tonemapping is not None:
        lines.append(f"tonemapping {_num(desc.tonemapping)}")
    if desc.seed is not None:
        lines.append(f"seed {desc.seed}")
    for i, o in enumerate(desc.objects):
        lines.append(f"object {obj_file(o.mesh, f'object{i}')} "
                     f"{nums(o.rgb)} {nums((o.ka, o.kd, o.ks, o.kt, o.n))}")
    path = os.path.join(directory, name)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
