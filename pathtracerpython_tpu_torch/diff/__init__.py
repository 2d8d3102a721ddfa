"""Differentiable rendering and inverse-rendering optimization: reverse-mode
pixel gradients with respect to albedo, emission, vertex positions and the
camera, and the optimizer loop that fits scene parameters to a target image
(the JAX package's ``diff``, on ``torch.autograd`` and ``torch.optim``).

The hard estimator's visibility carries no gradient; with
``RenderConfig.soft_vis_beta > 0`` the soft boundary estimator
(``diff/boundary.py``: smooth shadow coverage and silhouettes blended over
the surface behind them) makes silhouettes and shadow edges differentiable
in the geometry, and ``remat_bounces`` recomputes each bounce in the
backward instead of holding it.
"""

from pathtracerpython_tpu_torch.diff.boundary import (
    plane_hit_and_margin,
    soft_hits_sweep,
    soft_visibility,
)
from pathtracerpython_tpu_torch.diff.inverse import (
    CAMERA_FIELDS,
    PARAM_FIELDS,
    VERTEX_FIELDS,
    adam,
    apply_params,
    camera_pixel_loss,
    fit,
    make_render_fn,
    make_train_step,
    pixel_loss,
)

__all__ = [
    "CAMERA_FIELDS",
    "PARAM_FIELDS",
    "VERTEX_FIELDS",
    "adam",
    "apply_params",
    "camera_pixel_loss",
    "fit",
    "make_render_fn",
    "make_train_step",
    "pixel_loss",
    "plane_hit_and_margin",
    "soft_hits_sweep",
    "soft_visibility",
]
