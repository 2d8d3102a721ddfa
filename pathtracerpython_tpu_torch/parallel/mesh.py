"""Process meshes: how the ranks of the process group become named axes
(the JAX package's ``parallel/mesh.py`` on ``torch.distributed``).

- ``dp``   data parallel over rays, pixels and samples;
- ``geom`` the geometry axis, whose ranks each hold a shard of the
  triangle buffer and stream it around the ring of ``parallel/ring.py``;
- ``pp``   bounce stages of ``parallel/pipeline.py``.

Ranks are laid out row-major over the axes with ``geom`` the fastest-varying,
as ``jax.make_mesh`` lays out devices: ring neighbours are adjacent ranks
(on one host, adjacent cards), and ``pp`` is the slowest. Each axis, and
the ray axes dp x geom of a sharded render, has one process group per line
of ranks along it, created by ``dist.new_group`` in the same order on every
rank.

A mesh is made active by ``active(mesh)``, a context: the geometry ring
finds its process group there (``RenderConfig.geom_axis`` keeps only the
axis' name, so configs stay plain and hashable). ``carrying(fn)`` binds a
function to the active mesh, for a recompute that runs after the block.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math

import torch
import torch.distributed as dist

from pathtracerpython_tpu_torch.parallel import multihost


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Named axes over the ranks. ``shape``: axis -> size (JAX's
    ``mesh.shape``); ``coords``: this rank's index on each axis; ``groups``:
    a tuple of axes -> (the process group of this rank's line along them,
    or None where the line is one rank, and its global ranks in order)."""

    axis_names: tuple[str, ...]
    shape: dict
    coords: dict
    groups: dict
    device: torch.device
    rank: int

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def line(self, axes) -> tuple:
        """(group, global ranks) of this rank's line along ``axes`` (a name
        or a tuple of names, in mesh order)."""
        key = self._key(axes)
        if key not in self.groups:
            raise ValueError(f"the mesh makes groups for each axis and for "
                             f"{LINE_AXES}, not for {key}")
        return self.groups[key]

    def index(self, axes) -> int:
        """This rank's place on its line along ``axes``, row-major in mesh
        order: its group rank, since a line's ranks ascend."""
        i = 0
        for a in self._key(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def count(self, axes) -> int:
        """The number of ranks on a line along ``axes``."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in names)

    def _key(self, axes) -> tuple:
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in names if a not in self.shape]
        if unknown:
            raise ValueError(f"mesh has no axis {unknown} (axes "
                             f"{self.axis_names})")
        return tuple(a for a in self.axis_names if a in names)


# the one set of several axes a mesh makes groups for: the ray axes
LINE_AXES = ("dp", "geom")


def make_mesh(dp: int | None = None, geom: int = 1, pp: int = 1,
              device=None) -> Mesh:
    """A ("dp", "geom") mesh, or ("pp", "dp", "geom") when ``pp > 1``, over
    every rank of the initialised process group (one rank, the degenerate
    mesh, when none is). ``dp=None`` takes every rank left after the geom
    and pp split. ``device``: this rank's device (default: the one
    ``multihost.initialize`` chose). Raises ``ValueError`` unless
    ``dp * geom * pp`` is the world size."""
    world = multihost.world_size()
    if geom < 1 or pp < 1:
        raise ValueError(f"geom={geom} and pp={pp} must be >= 1")
    if dp is None:
        if world % (geom * pp):
            raise ValueError(f"world of {world} ranks is not a multiple of "
                             f"geom * pp = {geom * pp}")
        dp = world // (geom * pp)
    if dp * geom * pp != world:
        raise ValueError(f"mesh dp={dp} x geom={geom} x pp={pp} = "
                         f"{dp * geom * pp} ranks, but the world has {world}")
    if pp > 1:
        names, sizes = ("pp", "dp", "geom"), (pp, dp, geom)
    else:
        names, sizes = ("dp", "geom"), (dp, geom)
    me = multihost.rank()
    coords, rest = {}, me
    for name, size in reversed(list(zip(names, sizes))):
        coords[name] = rest % size
        rest //= size
    coords = {n: coords[n] for n in names}
    strides = {n: math.prod(sizes[i + 1:]) for i, n in enumerate(names)}
    groups = {}
    # the axis sets callers look up: each axis alone (the ring's geom, the
    # pipeline's pp, dp) and the ray axes (dp, geom) of a sharded render;
    # in one order on every rank, and every line of each, so that each
    # rank calls dist.new_group for every group
    for axes in [(n,) for n in names] + [LINE_AXES]:
        others = [n for n in names if n not in axes]
        for fixed in itertools.product(
                *(range(sizes[names.index(o)]) for o in others)):
            base = sum(f * strides[o] for f, o in zip(fixed, others))
            ranks = [base + sum(c * strides[a] for c, a in zip(idx, axes))
                     for idx in itertools.product(
                         *(range(sizes[names.index(a)]) for a in axes))]
            group = dist.new_group(ranks) if len(ranks) > 1 else None
            if me in ranks:
                groups[axes] = (group, tuple(ranks))
    return Mesh(axis_names=names, shape=dict(zip(names, sizes)),
                coords=coords, groups=groups,
                device=torch.device(device) if device is not None
                else multihost.device(), rank=me)


_ACTIVE: list = []


@contextlib.contextmanager
def active(mesh: Mesh):
    """Make ``mesh`` the one the geometry ring reads while the block runs;
    tables the ring derives for the shards it holds live as long as the
    block (``ring.home_tables``)."""
    _ACTIVE.append((mesh, {}))
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def carrying(fn):
    """``fn`` bound to the mesh (and block cache) active now: each call runs
    inside it again, for work that autograd reruns after the block has
    exited (a checkpointed bounce's recompute under a geometry ring, in
    the middle of the backward)."""
    entry = current()

    def run(*args, **kwargs):
        _ACTIVE.append(entry)
        try:
            return fn(*args, **kwargs)
        finally:
            _ACTIVE.pop()

    return run


def current() -> tuple:
    """(the active mesh, its per-block cache); raises outside ``active``."""
    if not _ACTIVE:
        raise RuntimeError(
            "a geometry ring (RenderConfig.geom_axis) runs only inside "
            "parallel.mesh.active(mesh); use parallel.render_sharded or "
            "render_rays_sharded")
    return _ACTIVE[-1]
