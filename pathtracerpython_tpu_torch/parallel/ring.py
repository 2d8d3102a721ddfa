"""Geometry ring: triangle shards streamed around a mesh axis (the JAX
package's ``parallel/ring.py`` on ``torch.distributed``).

For scenes whose triangle buffers exceed one card, each rank of the geom
axis holds one contiguous shard of the ``TRI_FIELDS`` (``shard.shard_scene``)
and keeps its rays where they are: it sweeps its rays against the shard it
holds, then passes the shard to the next rank of the ring and takes the one
before it (``RingShift``), ``n - 1`` times, so that every ray meets every
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

Gradients flow around the ring as they flow through JAX's ``ppermute``,
whose transpose is the reverse permutation. Every sweep passes its shards
through ``RingShift``, whose backward sends the gradients of the float
fields the rank received back to the rank it received them from; autograd
records the shift only where a shard's float ``TRI_FIELDS`` require grad
with grad mode on, so renders and the any-hits' detached shards build no
graph. Autograd adds each step's gradient to the
shard the rank held the step before, so every ray's gradient with respect
to a shard's rows ends on the shard's owner, on the rows of its home shard
(``shard.shard_scene``'s slice), and the sharded step's all-reduce over the
ray axes adds the owners' slices once each. ``nearest_hit_ring`` and the
soft sweeps (``soft_hits_ring``, ``soft_visibility_ring``: the dense tiles
of ``diff/boundary.py`` on every shard) are differentiable; the any-hits
detach the shard's fields, as the single-device any-hits do, and send
nothing backward.

Every rank issues its reverse shifts in the same order: autograd runs a
device's ready nodes by falling sequence number, so on every rank the
``RingShift`` nodes run in the reverse of the order they were made, and
every step's outputs stay in the graph (``torch.where`` over an all-false
mask still connects), so no rank skips a node its partner waits on. That
order is autograd's, not an API, so each reverse message leads with the
number of the forward shift it reverses, which every rank of a ring counts
alike, and a rank that receives another number raises instead of adding a
gradient meant for another shift.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

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
    safe_normalize,
)
from pathtracerpython_tpu_torch.parallel import mesh as mesh_mod
from pathtracerpython_tpu_torch.parallel.multihost import (
    pack_tensors,
    transport,
    unpack_tensors,
)
from pathtracerpython_tpu_torch.scene.arrays import TRI_FIELDS

# Since the last reset, this rank's forward rotations and the bytes they
# sent (a rank sends what it receives), and its reverse shifts (the
# backwards of ``RingShift``) and the gradient bytes they sent.
SHIFTS = 0
BYTES_SENT = 0
BACK_SHIFTS = 0
BACK_BYTES = 0
# The forward shifts ever made on each ring (by its ranks), never reset:
# every rank of a ring takes part in each of its shifts, so the ranks
# number them alike.
_MADE: dict = {}


def reset_counts() -> None:
    global SHIFTS, BYTES_SENT, BACK_SHIFTS, BACK_BYTES
    SHIFTS = BYTES_SENT = BACK_SHIFTS = BACK_BYTES = 0


@dataclasses.dataclass
class _Ring:
    """This rank's place on the ring of one axis."""

    group: object
    ranks: tuple
    me: int

    @property
    def n(self) -> int:
        return len(self.ranks)

    def peer(self, step: int) -> int:
        """The global rank ``step`` places along the ring from this one."""
        return self.ranks[(self.me + step) % self.n]


def _ring(axis: str) -> _Ring:
    mesh, _ = mesh_mod.current()
    group, ranks = mesh.line(axis)
    return _Ring(group, ranks, mesh.coords[axis])


class RingShift(torch.autograd.Function):
    """One rotation of the ring: ``tensors`` go to the next rank as one
    message, and the ones the rank before sent come back. The first
    ``n_diff`` are differentiable (the float ``TRI_FIELDS``; the integer
    and bool fields and the cull tables after them travel detached).

    The backward is the reverse shift: the gradients of the ``n_diff``
    tensors this rank received (zeros for a gradient that is None), behind
    the number of the forward shift, go back to the rank before as one
    message, and the ones the rank after sends back are the gradients of
    what this rank sent; a number other than this shift's raises
    ``RuntimeError``. The ring is kept on ``ctx``: the backward runs after
    the ``mesh.active`` block has exited."""

    @staticmethod
    def forward(ctx, ring, n_diff, *tensors):
        global SHIFTS, BYTES_SENT
        buffer = pack_tensors(tensors)
        got = transport("shift", buffer, ring.group, send_to=ring.peer(1),
                        recv_from=ring.peer(-1))
        SHIFTS += 1
        BYTES_SENT += buffer.numel()
        ctx.ring, ctx.n_diff = ring, n_diff
        ctx.made = _MADE.get(ring.ranks, 0)
        _MADE[ring.ranks] = ctx.made + 1
        got = unpack_tensors(got, tensors)
        ctx.mark_non_differentiable(*got[n_diff:])
        return tuple(got)

    @staticmethod
    def backward(ctx, *grads):
        global BACK_SHIFTS, BACK_BYTES
        ring = ctx.ring
        sent = [g.contiguous() for g in grads[:ctx.n_diff]]
        sent.insert(0, torch.tensor([ctx.made], device=sent[0].device))
        buffer = pack_tensors(sent)
        got = transport("shift", buffer, ring.group, send_to=ring.peer(-1),
                        recv_from=ring.peer(1))
        BACK_SHIFTS += 1
        BACK_BYTES += buffer.numel()
        made, *back = unpack_tensors(got, sent)
        if int(made) != ctx.made:
            raise RuntimeError(
                f"the reverse of ring shift {ctx.made} received the reverse "
                f"of shift {int(made)} from rank {ring.peer(1)}: the ranks "
                "ran their ring's backward nodes in different orders")
        return (None, None, *back, *([None] * (len(grads) - ctx.n_diff)))


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


def _steps(scene, ring: _Ring, tables=None):
    """Yield (owner, shard scene, tables) for each of the ring's n steps,
    rotating between steps through ``RingShift``, the float fields first in
    the message; the last step sends nothing further."""
    floats = [f for f in TRI_FIELDS if getattr(scene, f).is_floating_point()]
    fields = floats + [f for f in TRI_FIELDS if f not in floats]
    shard = scene
    for step in range(ring.n):
        yield (ring.me - step) % ring.n, shard, tables
        if step + 1 < ring.n:
            payload = [getattr(shard, f) for f in fields]
            if tables is not None:
                payload += [tables.tile, tables.group]
            got = RingShift.apply(ring, len(floats), *payload)
            shard = dataclasses.replace(
                shard, **dict(zip(fields, got[:len(fields)])))
            if tables is not None:
                tables = intersect.CullBoxes(*got[len(fields):])


def nearest_hit_ring(o3, d3, scene, axis: str, mode: str = "fast",
                     mt_impl: str | None = None):
    """The ring's closest hit of rays (o3, d3) [3, N] (``d3`` need not be
    normalized) as a component-major ``NearestHitCM`` with GLOBAL rows.
    Differentiable in the rays and, through ``RingShift``, in the float
    ``TRI_FIELDS`` of every shard: each step's t (K1 under
    ``intersect.NearestTIdx`` in fast mode, whose backward re-solves the
    step's shard's own rows; plain autograd in reference mode) and normal
    carry their graphs into the merge."""
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
    any-hit sweep (occluder rows only; ``d3_unit`` normalized). Occlusion
    is detached: the shards travel without a graph."""
    ring = _ring(axis)
    scene = scene.detach()
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
    every shard, or (-1, 0). Detached, as the any-hits are."""
    ring = _ring(axis)
    scene = scene.detach()
    shard_rows = scene.num_padded_triangles
    n = origin.shape[0]
    best = torch.full((n,), IMAX, dtype=torch.int32, device=origin.device)
    best_mat = torch.zeros(n, dtype=torch.int32, device=origin.device)
    for owner, shard, _ in _steps(scene, ring):
        local, mat = first_occluder_index(origin, direction, max_dist, shard)
        glob = torch.where(local >= 0, local + owner * shard_rows, IMAX)
        better = glob < best
        best = torch.where(better, glob.to(torch.int32), best)
        best_mat = torch.where(better, mat, best_mat)
    found = best != IMAX
    return (torch.where(found, best, -1), torch.where(found, best_mat, 0))


# --- the soft sweeps (diff/boundary.py) on the ring --------------------------

class SoftAttrs(NamedTuple):
    """What shading reads of a soft record's triangle, resolved in the ring
    step that held it (under a ring the local scene names another shard's
    rows)."""

    normal3: torch.Tensor   # f32[3, N]
    material: torch.Tensor  # i32[N]
    is_light: torch.Tensor  # bool[N]

    def where(self, mask, other: "SoftAttrs") -> "SoftAttrs":
        """These attributes on the lanes ``mask`` [N], ``other``'s
        elsewhere."""
        return SoftAttrs(
            torch.where(mask[None, :], self.normal3, other.normal3),
            torch.where(mask, self.material, other.material),
            torch.where(mask, self.is_light, other.is_light))


def _resolve(idx, before: list, shard, base: int) -> SoftAttrs:
    """The attributes of records ``idx`` [N] (global rows, IMAX for none,
    read as row 0 as the single-device record reads it) after a ring step
    over ``shard`` (global rows from ``base``): read from the shard where
    the row lies in it, else carried from the record of the same row before
    the step (``before``: (idx, ``SoftAttrs``) of every record), since a
    merge only keeps old records or takes the shard's, and may move a
    record from one slot to another (h1 to h2)."""
    def row(i):
        return torch.where(i == IMAX, 0, i)

    idx = row(idx)
    carried = before[0][1]
    for old_idx, old in before:
        carried = old.where(idx == row(old_idx), carried)
    local = idx - base
    mine = (local >= 0) & (local < shard.num_padded_triangles)
    rows = torch.where(mine, local, 0).to(torch.int64)
    return SoftAttrs(cm_take(shard.tri_normal.T, rows),
                     shard.tri_material[rows],
                     shard.tri_is_light[rows]).where(mine, carried)


def soft_hits_ring(origin, direction, scene, beta: float, axis: str):
    """``diff.boundary.soft_hits_sweep_dense`` over every shard of the ring:
    (``SoftHits`` with GLOBAL rows, {"f", "h1", "h2"} -> ``SoftAttrs``).

    One carry of ``boundary._dense_tile`` passes from tile to tile over
    each shard's tiles in turn, a tile's rows named from owner x shard rows
    + its start. Its merges are lexicographic on (key, global row), so F,
    h1 and h2 are the single-device dense records on every lane, t and
    margin to the bit, whatever order the shards arrive in. Each record's
    normal, material and light flag are read in the step whose shard holds
    its row (row 0's where there is none, as the single-device record
    reads them) and carried with the record after it. Dense tiles on every shard (the JAX ring streams dense sweeps
    too); tiles under ``torch.utils.checkpoint`` when grad is on, the
    shards through ``RingShift``."""
    from pathtracerpython_tpu_torch.diff import boundary as bd

    ring = _ring(axis)
    shard_rows = scene.num_padded_triangles
    n = origin.shape[0]
    d_unit = safe_normalize(direction)
    band = bd.BAND_SIGMAS * float(beta)
    big = origin.new_full((n,), bd.BIG)
    imax = torch.full((n,), bd.IMAX, dtype=torch.int32, device=origin.device)
    carry = (big, big, imax, origin.new_zeros((n,)), big, imax, big, imax)
    none = SoftAttrs(origin.new_zeros((3, n)),
                     torch.zeros(n, dtype=torch.int32, device=origin.device),
                     torch.zeros(n, dtype=torch.bool, device=origin.device))
    slots = {"f": 2, "h1": 5, "h2": 7}   # each record's row in the carry
    attrs = dict.fromkeys(slots, none)
    remat = bd._grad_on(scene, origin, direction)
    for owner, shard, _ in _steps(scene, ring):
        base = owner * shard_rows
        before = [(carry[i], attrs[k]) for k, i in slots.items()]
        for lo, hi in bd._tiles(shard_rows):
            carry = bd._run(remat, bd._dense_tile, carry, origin, d_unit,
                            shard.tri_v0[lo:hi], shard.tri_v1[lo:hi],
                            shard.tri_v2[lo:hi], shard.tri_valid[lo:hi],
                            base + lo, band)
        attrs = {k: _resolve(carry[i], before, shard, base)
                 for k, i in slots.items()}
    return bd.SoftHits(*carry[1:]), attrs


def soft_visibility_ring(origin, direction, max_dist, scene, beta: float,
                         axis: str) -> torch.Tensor:
    """``diff.boundary.soft_visibility`` over every shard of the ring: the
    sum of each shard's dense coverage (``boundary._soft_visibility_cov``),
    clamped once (``boundary._visibility``). The sums are added in the
    ring's order, so the visibility equals one device's up to rounding."""
    from pathtracerpython_tpu_torch.diff import boundary as bd

    ring = _ring(axis)
    cov = None
    for _, shard, _ in _steps(scene, ring):
        part = bd._soft_visibility_cov(origin, direction, max_dist, shard,
                                       beta)
        cov = part if cov is None else cov + part
    return bd._visibility(cov)
