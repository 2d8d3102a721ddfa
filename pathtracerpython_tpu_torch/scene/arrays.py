"""Device-side scene layout: flat SoA tensors, padded and masked.

The packing matches ``pathtracerpython_tpu/scene/arrays.py`` leaf for leaf:

- all object triangles in SDL order, then the light's triangles, then
  padding (this order reproduces the reference's nearest-hit tie-break:
  the first minimal element wins);
- per-triangle material indices into flat material rows (light = last row);
- masks instead of ``None``: ``tri_valid`` excludes padding, and
  ``tri_occluder`` also excludes the light's triangles, which never
  shadow;
- padding triangles are degenerate and sit at z = 1e8, so even unmasked
  arithmetic on them is inert.

``SceneTensors`` is a frozen dataclass of tensors; the render runs on the
device the leaves live on. The constructors (``pack_scene``, ``load_scene``,
``from_jax_scene``, ``from_numpy_leaves``) build on the card unless the
caller passes ``device="cpu"``: without a CUDA device they raise instead of
falling back. ``.to(device)`` moves every leaf.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pathtracerpython_tpu_torch.scene.sdl import SceneDescription, load_sdl


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static scene metadata."""

    width: int
    height: int
    n_triangles: int  # real triangles incl. light (before padding)
    n_object_triangles: int  # real object triangles (excl. light)
    n_objects: int
    n_light_triangles: int
    light_material: int  # material row index for the light (== n_objects)
    path: str = ""
    tonemapping: float | None = None
    seed: int | None = None
    npaths: int | None = None


# Tensor fields, in the JAX package's leaf order.
TRI_FIELDS = (
    "tri_v0", "tri_v1", "tri_v2", "tri_normal", "tri_area",
    "tri_material", "tri_valid", "tri_occluder", "tri_is_light",
)
DATA_FIELDS = TRI_FIELDS + (
    "mat_rgb", "mat_ka", "mat_kd", "mat_ks", "mat_kt", "mat_n",
    "light_v0", "light_v1", "light_v2", "light_area", "light_color",
    "light_tri_rows",
    "ambient", "eye", "ortho", "background",
)


@dataclasses.dataclass(frozen=True)
class SceneTensors:
    """Flat SoA scene. Shapes: T = padded triangle count, M = n_objects + 1
    material rows (light last), L = light triangle count."""

    # triangles (object tris, then light tris, then padding)
    tri_v0: torch.Tensor      # f32[T, 3]
    tri_v1: torch.Tensor      # f32[T, 3]
    tri_v2: torch.Tensor      # f32[T, 3]
    tri_normal: torch.Tensor  # f32[T, 3]  geometric normal from winding
    tri_area: torch.Tensor    # f32[T]
    tri_material: torch.Tensor  # i32[T]
    tri_valid: torch.Tensor     # bool[T]  excludes padding
    tri_occluder: torch.Tensor  # bool[T]  valid & not light
    tri_is_light: torch.Tensor  # bool[T]
    # materials (row per SDL object + final light row)
    mat_rgb: torch.Tensor  # f32[M, 3]
    mat_ka: torch.Tensor   # f32[M]
    mat_kd: torch.Tensor   # f32[M]
    mat_ks: torch.Tensor   # f32[M]
    mat_kt: torch.Tensor   # f32[M]
    mat_n: torch.Tensor    # f32[M]
    # light source (NEE sampling set; duplicated from the tri buffer tail)
    light_v0: torch.Tensor    # f32[L, 3]
    light_v1: torch.Tensor    # f32[L, 3]
    light_v2: torch.Tensor    # f32[L, 3]
    light_area: torch.Tensor  # f32[L]
    light_color: torch.Tensor  # f32[3]
    light_tri_rows: torch.Tensor  # i32[L] row of light triangle l in tri_*
    # globals
    ambient: torch.Tensor     # f32[]
    eye: torch.Tensor         # f32[3]
    ortho: torch.Tensor       # f32[4]  (x0, y0, x1, y1)
    background: torch.Tensor  # f32[3]
    meta: SceneMeta

    @property
    def num_padded_triangles(self) -> int:
        return int(self.tri_v0.shape[0])

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    def to(self, device) -> "SceneTensors":
        """The same scene with every tensor on ``device``."""
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in DATA_FIELDS}
        )

    def detach(self) -> "SceneTensors":
        """The same scene with every tensor detached from autograd: views of
        the same storage, what the kernels read (a sweep's winners and
        occlusion are discrete, and its gradient is re-solved apart)."""
        return dataclasses.replace(
            self, **{f: getattr(self, f).detach() for f in DATA_FIELDS}
        )


def _morton_argsort(centroids: np.ndarray) -> np.ndarray:
    """Spatial (Z-order) sort of triangle centroids."""
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    q = ((centroids - lo) / np.maximum(hi - lo, 1e-12) * 1023.0)
    q = np.clip(q, 0, 1023).astype(np.uint32)

    def spread(x):
        x = (x | (x << 16)) & np.uint32(0x030000FF)
        x = (x | (x << 8)) & np.uint32(0x0300F00F)
        x = (x | (x << 4)) & np.uint32(0x030C30C3)
        x = (x | (x << 2)) & np.uint32(0x09249249)
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return np.argsort(code, kind="stable")


def _median_split_argsort(cent: np.ndarray, leaf: int = 128) -> np.ndarray:
    """Order triangles into median-split BVH leaves of ``leaf`` rows:
    recursive widest-axis median splits, each split point rounded to a
    multiple of ``leaf`` so interior leaves stay exactly full."""
    out = []
    stack = [np.arange(cent.shape[0])]
    while stack:
        ids = stack.pop()
        if len(ids) <= leaf:
            out.append(ids)
            continue
        c = cent[ids]
        ax = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        srt = ids[np.argsort(c[:, ax], kind="stable")]
        half = max(leaf, ((len(ids) // 2 + leaf - 1) // leaf) * leaf)
        if half >= len(ids):
            half = len(ids) - leaf
        stack.append(srt[:half])
        stack.append(srt[half:])
    return np.concatenate(out)


def _pack_numpy(
    desc: SceneDescription, pad_to: int, dtype, tri_order: str | None,
) -> tuple[dict[str, np.ndarray], SceneMeta]:
    """The packed leaves as numpy arrays, and the scene's metadata."""
    if not desc.objects:
        raise ValueError("scene has no objects")
    if desc.light_mesh is None:
        raise ValueError("scene has no light")

    v0s, v1s, v2s, normals, areas, mats, is_light = [], [], [], [], [], [], []
    for i, obj in enumerate(desc.objects):
        a, b, c = obj.mesh.triangle_vertices()
        v0s.append(a); v1s.append(b); v2s.append(c)
        normals.append(obj.mesh.normals)
        areas.append(obj.mesh.areas)
        mats.append(np.full(obj.mesh.num_triangles, i, dtype=np.int32))
        is_light.append(np.zeros(obj.mesh.num_triangles, dtype=bool))
    n_obj_tris = sum(o.mesh.num_triangles for o in desc.objects)

    lm = desc.light_mesh
    la, lb, lc = lm.triangle_vertices()
    v0s.append(la); v1s.append(lb); v2s.append(lc)
    normals.append(lm.normals)
    areas.append(lm.areas)
    n_objects = len(desc.objects)
    mats.append(np.full(lm.num_triangles, n_objects, dtype=np.int32))
    is_light.append(np.ones(lm.num_triangles, dtype=bool))

    tri_v0 = np.concatenate(v0s).astype(dtype)
    tri_v1 = np.concatenate(v1s).astype(dtype)
    tri_v2 = np.concatenate(v2s).astype(dtype)
    tri_normal = np.concatenate(normals).astype(dtype)
    tri_area = np.concatenate(areas).astype(dtype)
    tri_material = np.concatenate(mats)
    tri_is_light = np.concatenate(is_light)
    n_tris = tri_v0.shape[0]

    light_tri_rows = n_obj_tris + np.arange(lm.num_triangles, dtype=np.int32)
    if tri_order is not None and tri_order != "none":
        cent = (tri_v0 + tri_v1 + tri_v2) / 3.0
        if tri_order == "morton":
            order = _morton_argsort(cent)
        elif tri_order == "median":
            order = _median_split_argsort(cent)
        else:
            raise ValueError(f"unknown tri_order {tri_order!r}")
        tri_v0, tri_v1, tri_v2 = tri_v0[order], tri_v1[order], tri_v2[order]
        tri_normal, tri_area = tri_normal[order], tri_area[order]
        tri_material = tri_material[order]
        tri_is_light = tri_is_light[order]
        inverse = np.empty_like(order)
        inverse[order] = np.arange(order.shape[0])
        light_tri_rows = inverse[light_tri_rows].astype(np.int32)

    T = max(_round_up(n_tris, pad_to), pad_to)
    pad = T - n_tris

    def pad0(x):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, widths)

    tri_valid = pad0(np.ones(n_tris, dtype=bool))
    far = np.zeros((pad, 3), dtype=dtype) + np.asarray([0.0, 0.0, 1e8], dtype)

    leaves = dict(
        tri_v0=np.concatenate([tri_v0, far]),
        tri_v1=np.concatenate([tri_v1, far]),
        tri_v2=np.concatenate([tri_v2, far]),
        tri_normal=pad0(tri_normal),
        tri_area=pad0(tri_area),
        tri_material=pad0(tri_material),
        tri_valid=tri_valid,
        tri_occluder=tri_valid & ~pad0(tri_is_light),
        tri_is_light=pad0(tri_is_light),
        mat_rgb=np.asarray(
            [list(o.rgb) for o in desc.objects] + [[0.0, 0.0, 0.0]], dtype
        ),
        mat_ka=np.asarray([o.ka for o in desc.objects] + [0.0], dtype),
        mat_kd=np.asarray([o.kd for o in desc.objects] + [0.0], dtype),
        mat_ks=np.asarray([o.ks for o in desc.objects] + [0.0], dtype),
        mat_kt=np.asarray([o.kt for o in desc.objects] + [0.0], dtype),
        mat_n=np.asarray([o.n for o in desc.objects] + [1.0], dtype),
        light_v0=la.astype(dtype),
        light_v1=lb.astype(dtype),
        light_v2=lc.astype(dtype),
        light_area=lm.areas.astype(dtype),
        light_color=np.asarray(desc.light_color, dtype),
        light_tri_rows=light_tri_rows,
        ambient=np.asarray(
            desc.ambient if desc.ambient is not None else 0.0, dtype
        ),
        eye=np.asarray(desc.eye, dtype),
        ortho=np.asarray(desc.ortho, dtype),
        background=np.asarray(desc.background or (0.0, 0.0, 0.0), dtype),
    )
    meta = SceneMeta(
        width=desc.width,
        height=desc.height,
        n_triangles=n_tris,
        n_object_triangles=n_obj_tris,
        n_objects=n_objects,
        n_light_triangles=lm.num_triangles,
        light_material=n_objects,
        path=desc.path,
        tonemapping=desc.tonemapping,
        seed=desc.seed,
        npaths=desc.npaths,
    )
    return leaves, meta


def resolve_device(device=None) -> torch.device:
    """The device a scene is built on: ``device`` when given, else the
    card. Without a CUDA device the default raises; it never falls back to
    the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: scenes are built on the card by default; pass "
            'device="cpu" to build (and render) on the CPU'
        )
    return torch.device("cuda")


def from_numpy_leaves(leaves: dict[str, np.ndarray], meta: SceneMeta,
                      device=None) -> SceneTensors:
    """``SceneTensors`` on ``device`` (None: the card) from a dict of numpy
    leaves keyed by DATA_FIELDS."""
    device = resolve_device(device)
    missing = set(DATA_FIELDS) - set(leaves)
    if missing:
        raise ValueError(f"missing scene fields: {sorted(missing)}")
    return SceneTensors(
        **{f: torch.from_numpy(np.array(leaves[f])).to(device)
           for f in DATA_FIELDS},
        meta=meta,
    )


def from_jax_scene(leaves: dict[str, np.ndarray], meta,
                   device=None) -> SceneTensors:
    """Build the port's scene on ``device`` (None: the card) from the numpy
    leaves of a JAX ``SceneArrays``
    (``{f: np.asarray(getattr(scene, f)) for f in DATA_FIELDS}``) and its
    ``SceneMeta``, so both packages render the very same buffers. Takes
    only numpy arrays and plain attributes; never imports jax."""
    port_meta = SceneMeta(
        **{f.name: getattr(meta, f.name)
           for f in dataclasses.fields(SceneMeta)}
    )
    return from_numpy_leaves(leaves, port_meta, device=device)


def pack_scene(
    desc: SceneDescription, pad_to: int = 128, dtype=np.float32,
    tri_order: str | None = None, device=None,
) -> SceneTensors:
    """Pack a parsed SDL scene into padded SoA tensors on ``device``: the
    card when None (a ``RuntimeError`` without one), the CPU for
    ``device="cpu"``.

    ``tri_order`` spatially sorts the triangle buffer: "morton" (centroid
    z-order) or "median" (median-split BVH leaves).
    """
    device = resolve_device(device)  # refuse before the packing work
    leaves, meta = _pack_numpy(desc, pad_to, dtype, tri_order)
    return from_numpy_leaves(leaves, meta, device=device)


def load_scene(
    path: str, pad_to: int = 128, dtype=np.float32,
    tri_order: str | None = None, device=None,
) -> SceneTensors:
    """Parse an SDL file and pack it on ``device`` (None: the card)."""
    return pack_scene(load_sdl(path), pad_to=pad_to, dtype=dtype,
                      tri_order=tri_order, device=device)


def recompute_derived(scene: SceneTensors) -> SceneTensors:
    """Normals and areas recomputed from the vertices, differentiably, as
    the JAX package's ``recompute_derived``: ``pack_scene`` derives
    ``tri_normal``, ``tri_area`` and ``light_area`` on the host, so a scene
    whose vertices are parameters runs through this for those to carry
    gradients. Padding rows keep their packed values."""
    def derive(v0, v1, v2):
        cross = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
        # the guard comes before the sqrt: d(sqrt)/dx at 0 is inf, and
        # inf * 0 is NaN in the backward of a degenerate (padding) row
        sq = (cross * cross).sum(dim=-1, keepdim=True)
        degenerate = sq == 0.0
        norm = torch.sqrt(torch.where(degenerate, 1.0, sq))
        normal = torch.where(degenerate, 0.0, cross / norm)
        area = torch.where(degenerate[..., 0], 0.0, norm[..., 0] / 2.0)
        return normal, area

    tri_normal, tri_area = derive(scene.tri_v0, scene.tri_v1, scene.tri_v2)
    _, light_area = derive(scene.light_v0, scene.light_v1, scene.light_v2)
    return dataclasses.replace(
        scene,
        tri_normal=torch.where(scene.tri_valid[:, None], tri_normal,
                               scene.tri_normal),
        tri_area=torch.where(scene.tri_valid, tri_area, scene.tri_area),
        light_area=light_area,
    )
