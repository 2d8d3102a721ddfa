"""Differentiable rendering and inverse-rendering optimization: reverse-mode
pixel gradients with respect to albedo, emission, vertex positions and the
camera, and the optimizer loop that fits scene parameters to a target image
(the JAX package's ``diff``, on ``torch.autograd`` and ``torch.optim``).

The hard estimator only: the soft boundary estimator (``diff/boundary.py``
of the JAX package, ``soft_vis_beta > 0``) is not ported yet.
"""

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
]
