"""Distributed execution on ``torch.distributed``: process meshes, sharded
rendering, the geometry ring and the bounce pipeline (the JAX package's
``parallel/``).

Rays and pixels split over data-parallel mesh axes (``shard.py``); scene
triangles either stay whole on every rank or split over a geometry axis and
stream around a ring of ranks (``ring.py``), triangles playing the part of
ring attention's key-value context; bounce stages split over a pipeline
axis (``pipeline.py``). ``multihost.py`` joins the process group (torchrun
or explicit arguments) and moves every tensor between ranks; ``mesh.py``
names the axes. Every sharded entry point returns the whole result on every
rank.

    # python -m torch.distributed.run --nproc-per-node 2 script.py
    from pathtracerpython_tpu_torch.parallel import (
        make_mesh, multihost, render_sharded)
    multihost.initialize()
    mesh = make_mesh(dp=2)
    radiance = render_sharded(scene.to(mesh.device), cfg, mesh, seed=1)
"""

from pathtracerpython_tpu_torch.parallel import multihost
from pathtracerpython_tpu_torch.parallel.mesh import Mesh, make_mesh
from pathtracerpython_tpu_torch.parallel.pipeline import render_pipelined
from pathtracerpython_tpu_torch.parallel.shard import (
    render_rays_sharded,
    render_sharded,
    shard_scene,
)

__all__ = [
    "Mesh",
    "make_mesh",
    "multihost",
    "render_pipelined",
    "render_rays_sharded",
    "render_sharded",
    "shard_scene",
]
