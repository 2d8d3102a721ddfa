"""Render configuration: the fields and defaults of the JAX package's
``render/config.py``, less ``backend`` (the device the scene lives on
decides: CUDA kernels on the card, their plain versions on the CPU) and
``tile`` (the reference sweeps take JAX's default, ``ops/geometry.py:TILE``).

The port runs the forward render in both estimators: the fast one, dense
(``accel="none"``) or through a cluster hierarchy: ``"sparse"``,
``"walker"`` or ``"hybrid"`` (which ``"auto"`` selects on large scenes),
with the sparse hierarchy's occluder cache on ``nee_cache="on"`` ("auto" is
off); and ``mode="reference"``, whose sweeps ignore ``accel``.
``geom_axis`` names the mesh axis of a geometry ring
(``parallel/ring.py``); ``parallel.shard.render_rays_sharded`` sets it with
``geom_axis_size`` and makes the mesh active, whose process group the ring
reads, so a config stays plain and hashable.

One field the JAX package does not have: ``mt_impl``, the form of the
in-triangle test ("classic" or "plucker") in the sweeps that have both.
None, the default, follows the knob ``kernels.intersect.MT_IMPL``, which
is how the JAX package selects it."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration for the wavefront integrator (see the JAX
    package's ``RenderConfig`` for what each field selects)."""

    mode: str = "fast"
    accel: str = "auto"
    sort_rays: str = "auto"
    sort_nee: str = "auto"
    nee_hint: str = "auto"
    nee_cache: str = "auto"
    use_background: bool = False
    soft_vis_beta: float = 0.0
    n_samples: int = 1        # rays per pixel (the reference CLI's -r)
    n_bounces: int = 1        # bounces      (the reference CLI's -b)
    n_light_samples: int = 3  # NEE samples per bounce
    remat_bounces: bool = False
    batch_samples: bool = False  # all spp in one wavefront (fewer kernel
    #                              launches, n_samples x the live ray state)
    geom_axis: str | None = None
    geom_axis_size: int = 0
    mt_impl: str | None = None  # None: follow kernels.intersect.MT_IMPL

    def __post_init__(self):
        def need(ok: bool, what: str):
            if not ok:
                raise ValueError(f"RenderConfig: {what}")

        need(self.mode in ("fast", "reference"), f"mode={self.mode!r}")
        need(self.accel in ("auto", "sparse", "walker", "hybrid", "none"),
             f"accel={self.accel!r}")
        for name in ("sort_rays", "nee_cache", "nee_hint", "sort_nee"):
            value = getattr(self, name)
            need(value in ("auto", "on", "off"), f"{name}={value!r}")
        need(self.mt_impl in (None, "classic", "plucker"),
             f"mt_impl={self.mt_impl!r}")
        need(self.soft_vis_beta >= 0.0, "soft_vis_beta must be >= 0")
        need(not (self.soft_vis_beta > 0.0 and self.mode == "reference"),
             "soft visibility is a fast-mode feature")
        need(self.n_samples >= 1 and self.n_bounces >= 1,
             "n_samples and n_bounces must be >= 1")
        need(self.n_light_samples >= 1, "n_light_samples must be >= 1")
        need((self.geom_axis is None) == (self.geom_axis_size == 0),
             "geom_axis and geom_axis_size go together")
