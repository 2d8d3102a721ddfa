"""Shared helpers of the parity tests between the PyTorch port
(``pathtracerpython_tpu_torch``) and the JAX package: the same scene
description, built from the same vertex and face arrays, goes to both."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pathtracerpython_tpu.kernels import sparse_pallas as sp
from pathtracerpython_tpu.scene import obj as jax_obj
from pathtracerpython_tpu.scene import arrays as jax_arrays
from pathtracerpython_tpu.scene import sdl as jax_sdl
from pathtracerpython_tpu.scene.arrays import DATA_FIELDS
from pathtracerpython_tpu_torch.ops.geometry import normalize3
from pathtracerpython_tpu_torch.ops.sort import PARK_DIR, PARK_ORIGIN
from pathtracerpython_tpu_torch.scene import arrays as port_arrays

# Tolerances of the kernels' plain versions against the JAX kernels in
# interpret mode: the same float32 operations, but XLA:CPU may fuse a
# product into an add and its rsqrt is not correctly rounded, so results
# can differ in the last bits, and a winner or an occlusion bit may flip
# only where a ray grazes a triangle edge.
T_RTOL = T_ATOL = 1e-6
GRAZING_MARGIN = 1e-5


def field_rays(n, seed, parked=()):
    """Incoherent rays inside a box field (tests/test_sparse.py's
    ``_random_rays``) as torch tensors o3, d3u f32[3, n], with the lane
    ranges ``parked`` parked as the integrator parks dead lanes."""
    rs = np.random.default_rng(seed)
    o = rs.uniform([-8, -1, -16], [8, 1.5, 3], (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    for lo, hi in parked:
        o[lo:hi] = PARK_ORIGIN
        d[lo:hi] = PARK_DIR
    o3 = torch.from_numpy(np.ascontiguousarray(o.T))
    return o3, normalize3(torch.from_numpy(np.ascontiguousarray(d.T)))


def to_jax_desc(desc):
    """The JAX package's SceneDescription for the port's ``desc``."""
    def mesh(m):
        return jax_obj.mesh_from_arrays(m.vertices, m.faces, path=m.path)

    fields = {f.name: getattr(desc, f.name)
              for f in dataclasses.fields(desc)}
    fields["light_mesh"] = mesh(desc.light_mesh)
    fields["objects"] = [
        jax_sdl.SdlObject(mesh=mesh(o.mesh), rgb=o.rgb, ka=o.ka, kd=o.kd,
                          ks=o.ks, kt=o.kt, n=o.n)
        for o in desc.objects
    ]
    return jax_sdl.SceneDescription(**fields)


def pack_pair(desc, **pack):
    """(the port's packing on the CPU, the JAX package's packing) of one
    description; ``tri_order="morton"`` is JAX's ``morton_order=True``."""
    jax_pack = dict(pack)
    if jax_pack.pop("tri_order", None) == "morton":
        jax_pack["morton_order"] = True
    return (port_arrays.pack_scene(desc, **pack, device="cpu"),
            jax_arrays.pack_scene(to_jax_desc(desc), **jax_pack))


def jax_leaves(scene) -> dict[str, np.ndarray]:
    """A JAX SceneArrays' leaves as numpy arrays keyed by field name."""
    return {f: np.asarray(getattr(scene, f)) for f in DATA_FIELDS}


def port_leaves(scene) -> dict[str, np.ndarray]:
    return {f: getattr(scene, f).cpu().numpy() for f in DATA_FIELDS}


def bary_margin_f64(v0, v1, v2, o, d) -> float:
    """min(u, v, 1-u-v) of ray (o, d) against triangle (v0, v1, v2),
    computed in float64: how far inside the triangle the hit lies."""
    v0, v1, v2, o, d = (np.asarray(a, np.float64) for a in (v0, v1, v2, o, d))
    e1, e2 = v1 - v0, v2 - v0
    pv = np.cross(d, e2)
    det = np.dot(e1, pv)
    if abs(det) < 1e-300:
        return 0.0
    tv = o - v0
    u = np.dot(tv, pv) / det
    v = np.dot(d, np.cross(tv, e1)) / det
    return min(u, v, 1.0 - u - v)


def occlusion_margin_f64(tri_v0, tri_v1, tri_v2, o, d, dist,
                         t_min: float = 1e-4) -> float:
    """Signed float64 distance of a shadow ray's verdict from flipping: the
    largest, over the triangles given, of min(u, v, 1-u-v, t - t_min,
    dist - t_min - t) — positive when some triangle blocks the ray with
    room to spare, negative when every one misses by that much."""
    best = -np.inf
    o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)
    for v0, v1, v2 in zip(tri_v0, tri_v1, tri_v2):
        v0, v1, v2 = (np.asarray(a, np.float64) for a in (v0, v1, v2))
        e1, e2 = v1 - v0, v2 - v0
        pv = np.cross(d, e2)
        det = np.dot(e1, pv)
        if abs(det) < 1e-300:
            continue
        tv = o - v0
        qv = np.cross(tv, e1)
        u = np.dot(tv, pv) / det
        v = np.dot(d, qv) / det
        t = np.dot(e2, qv) / det
        best = max(best, min(u, v, 1.0 - u - v, t - t_min,
                             float(dist) - t_min - t))
    return best


def decode_grouped(packs, nrb, ordered: bool = False):
    """Per-block cluster sets (``ordered``: lists in visit order) of the JAX
    package's G-cluster work words (``grouped_worklist``,
    ``guess_worklist``): word 0 is [seg][active][rb 14][cl 12], follower k
    is [valid][cl 12]."""
    sets = [[] for _ in range(nrb)]
    lead = np.asarray(packs[0])
    for pos, word in enumerate(lead):
        if not (word >> sp._ACT_BIT) & 1:
            continue
        rb = (word >> sp._CL_BITS) & ((1 << sp._RB_BITS) - 1)
        sets[rb].append(int(word & ((1 << sp._CL_BITS) - 1)))
        for follower in packs[1:]:
            w = int(np.asarray(follower)[pos])
            if (w >> sp._VAL_BIT) & 1:
                sets[rb].append(w & ((1 << sp._CL_BITS) - 1))
    return sets if ordered else [set(s) for s in sets]
