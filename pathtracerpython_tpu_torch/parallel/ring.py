"""Geometry ring: triangle shards streamed around a mesh axis (the JAX
package's ``parallel/ring.py`` on ``torch.distributed``).

For scenes whose triangle buffers exceed one card, each rank of the geom
axis holds one contiguous shard of the ``TRI_FIELDS`` (``shard.shard_scene``)
and keeps its rays where they are: it sweeps its rays against the shard it
holds, then passes the shard to the next rank of the ring and takes the one
before it (``ring_shift``), ``n - 1`` times, so that every ray meets every
triangle once. Each step sweeps with the kernels of the single-device path:
in fast mode K1 (``kernels/intersect.py:nearest_t_idx_cm``) and K4
(``any_hit_cm``) on the card, their plain versions on the CPU; in reference
mode the row-major plain sweeps of ``ops/geometry.py``.

The contract is JAX's:

- a winner's global row is its local row plus owner x shard rows, where
  the rank holds at step s the shard of owner (me - s) mod n;
- the ordering key is t in fast mode and t * t in reference mode;
- exactly equal keys go to the lowest global row, so the order in which the
  shards arrive never shows in a result (the dense sweep's first minimum);
- normal, material and light flag are read in the step that held the
  winning shard; ``first_occluder_ring`` keeps the lowest blocking row.

The culled kernels read per-shard box tables (``intersect.nearest_cull_boxes``
and ``cull_boxes``). A rank builds its home shard's tables once per
``mesh.active`` block (once a render) and the tables travel with the shard,
in the same message, so no step rebuilds them and the one-scene cache of
``kernels/intersect.py`` is not touched. On the CPU the plain sweeps read no
tables and none travel.

A shard that arrives by ``recv`` carries no autograd graph, so a gradient
with respect to the ``TRI_FIELDS`` cannot flow around the ring yet: a ring
sweep whose scene's triangle tensors require grad raises
``NotImplementedError`` (ROADMAP.md queue A, A4b) instead of dropping it.
Gradients with respect to the rays (the camera) flow: each step's t carries
its sweep's backward.
"""

from __future__ import annotations

import dataclasses

import torch

from pathtracerpython_tpu_torch.kernels import intersect
from pathtracerpython_tpu_torch.ops.gather import cm_take
from pathtracerpython_tpu_torch.ops.geometry import (
    IMAX,
    NearestHitCM,
    any_hit_within,
    first_occluder_index,
    nearest_hit,
    normalize3,
)
from pathtracerpython_tpu_torch.parallel import mesh as mesh_mod
from pathtracerpython_tpu_torch.parallel.multihost import (
    pack_tensors,
    transport,
    unpack_tensors,
)
from pathtracerpython_tpu_torch.scene.arrays import TRI_FIELDS

# Rotations made and bytes this rank sent since the last reset: the ring's
# traffic (a rank sends what it receives).
SHIFTS = 0
BYTES_SENT = 0


def reset_counts() -> None:
    global SHIFTS, BYTES_SENT
    SHIFTS = BYTES_SENT = 0


@dataclasses.dataclass
class _Ring:
    """This rank's place on the ring of one axis."""

    group: object
    ranks: tuple
    me: int

    @property
    def n(self) -> int:
        return len(self.ranks)


def _ring(axis: str) -> _Ring:
    mesh, _ = mesh_mod.current()
    group, ranks = mesh.line(axis)
    return _Ring(group, ranks, mesh.coords[axis])


def ring_shift(tensors: list, ring: _Ring) -> list:
    """Send ``tensors`` to the next rank of the ring and return the ones the
    rank before sent, as one message."""
    global SHIFTS, BYTES_SENT
    buffer = pack_tensors(tensors)
    got = transport("shift", buffer, ring.group,
                    send_to=ring.ranks[(ring.me + 1) % ring.n],
                    recv_from=ring.ranks[(ring.me - 1) % ring.n])
    SHIFTS += 1
    BYTES_SENT += buffer.numel()
    return unpack_tensors(got, tensors)


def _refuse_tri_grad(scene) -> None:
    if torch.is_grad_enabled() and any(
            getattr(scene, f).requires_grad for f in TRI_FIELDS):
        raise NotImplementedError(
            "gradients with respect to the triangle buffers (tri_*, and the "
            "light's vertices, which move its rows) under a geometry ring "
            "are not supported: shards that arrive by recv carry no graph "
            "(ROADMAP.md queue A, A4b: triangle gradients around the ring); "
            "shard the rays only (geom_axis=None)")


def home_tables(scene, kind: str):
    """The cull boxes of the shard this rank was born with (``kind``
    "nearest" or "occluder"), built once per ``mesh.active`` block; None on
    the CPU, whose plain sweeps read none."""
    if scene.device.type != "cuda":
        return None
    _, cache = mesh_mod.current()
    key = (kind, scene.tri_v0.data_ptr())
    if key not in cache:
        with torch.no_grad():
            tripack = intersect.scene_tripack(scene)
            cache[key] = (intersect.nearest_cull_boxes(tripack)
                          if kind == "nearest" else
                          intersect.cull_boxes(tripack))
    return cache[key]


def _steps(scene, ring: _Ring, tables):
    """Yield (owner, shard scene, tables) for each of the ring's n steps,
    rotating between steps; the last step sends nothing further."""
    shard = scene
    for step in range(ring.n):
        yield (ring.me - step) % ring.n, shard, tables
        if step + 1 < ring.n:
            payload = [getattr(shard, f) for f in TRI_FIELDS]
            if tables is not None:
                payload += [tables.tile, tables.group]
            got = ring_shift(payload, ring)
            shard = dataclasses.replace(
                shard, **dict(zip(TRI_FIELDS, got[:len(TRI_FIELDS)])))
            if tables is not None:
                tables = intersect.CullBoxes(*got[len(TRI_FIELDS):])


def nearest_hit_ring(o3, d3, scene, axis: str, mode: str = "fast",
                     mt_impl: str | None = None):
    """The ring's closest hit of rays (o3, d3) [3, N] (``d3`` need not be
    normalized) as a component-major ``NearestHitCM`` with GLOBAL rows."""
    _refuse_tri_grad(scene)
    ring = _ring(axis)
    shard_rows = scene.num_padded_triangles
    n = o3.shape[1]
    big = torch.finfo(o3.dtype).max
    dev = o3.device
    best_key = torch.full((n,), big, dtype=o3.dtype, device=dev)
    best_idx = torch.zeros(n, dtype=torch.int32, device=dev)
    best_t = torch.zeros(n, dtype=o3.dtype, device=dev)
    best_point3 = torch.zeros_like(o3)
    best_normal3 = torch.zeros_like(o3)
    best_mat = torch.zeros(n, dtype=torch.int32, device=dev)
    best_light = torch.zeros(n, dtype=torch.bool, device=dev)
    fast = mode == "fast"
    d3u = normalize3(d3) if fast else None
    tables = home_tables(scene, "nearest") if fast else None
    for owner, shard, cull in _steps(scene, ring, tables):
        if fast:
            t, idx = intersect.nearest_t_idx_cm(o3, d3u, shard,
                                                mt_impl=mt_impl, cull=cull)
            found = idx >= 0
            rows = idx.clamp_min(0).to(torch.int64)
            point3 = o3 + d3u * t[None, :]
            normal3 = cm_take(shard.tri_normal.T, rows)
            key = torch.where(found, t, big)
        else:
            hit = nearest_hit(o3.T, d3.T, shard, mode=mode)
            found, t = hit.hit, hit.t
            rows = hit.tri_idx.to(torch.int64)
            point3, normal3 = hit.point.T, hit.normal.T
            key = torch.where(found, t * t, big)
        glob = (rows + owner * shard_rows).to(torch.int32)
        better = (key < best_key) | ((key == best_key) & found
                                     & (glob < best_idx))
        best_key = torch.where(better, key, best_key)
        best_idx = torch.where(better, glob, best_idx)
        best_t = torch.where(better, t, best_t)
        best_point3 = torch.where(better[None, :], point3, best_point3)
        best_normal3 = torch.where(better[None, :], normal3, best_normal3)
        best_mat = torch.where(better, shard.tri_material[rows], best_mat)
        best_light = torch.where(better, shard.tri_is_light[rows] & found,
                                 best_light)
    return NearestHitCM(hit=best_key < big, t=best_t, tri_idx=best_idx,
                        point3=best_point3, normal3=best_normal3,
                        material=best_mat, is_light=best_light)


def any_hit_ring(o3, d3_unit, max_dist, scene, axis: str,
                 mode: str = "fast", mt_impl: str | None = None):
    """The ring's shadow occlusion bool[N]: the OR over the shards of the
    any-hit sweep (occluder rows only; ``d3_unit`` normalized)."""
    _refuse_tri_grad(scene)
    ring = _ring(axis)
    fast = mode == "fast"
    occluded = torch.zeros(o3.shape[1], dtype=torch.bool, device=o3.device)
    tables = home_tables(scene, "occluder") if fast else None
    for _, shard, cull in _steps(scene, ring, tables):
        if fast:
            occ = intersect.any_hit_cm(o3, d3_unit, max_dist, shard,
                                       mt_impl=mt_impl, cull=cull)
        else:
            occ = any_hit_within(o3.T, d3_unit.T, max_dist, shard,
                                 mode=mode)
        occluded = occluded | occ
    return occluded


def first_occluder_ring(origin, direction, max_dist, scene, axis: str):
    """Ring form of ``ops.geometry.first_occluder_index`` on row-major
    rays: (global row, material) of the lowest blocking occluder row over
    every shard, or (-1, 0)."""
    _refuse_tri_grad(scene)
    ring = _ring(axis)
    shard_rows = scene.num_padded_triangles
    n = origin.shape[0]
    best = torch.full((n,), IMAX, dtype=torch.int32, device=origin.device)
    best_mat = torch.zeros(n, dtype=torch.int32, device=origin.device)
    for owner, shard, _ in _steps(scene, ring, None):
        local, mat = first_occluder_index(origin, direction, max_dist, shard)
        glob = torch.where(local >= 0, local + owner * shard_rows, IMAX)
        better = glob < best
        best = torch.where(better, glob.to(torch.int32), best)
        best_mat = torch.where(better, mat, best_mat)
    found = best != IMAX
    return (torch.where(found, best, -1), torch.where(found, best_mat, 0))
