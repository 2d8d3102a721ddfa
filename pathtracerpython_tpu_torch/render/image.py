"""Radiance -> image conversion, as the JAX package's ``render/image.py``.

The flat x-outer / y-inner radiance [W*H, 3] is laid out as a canvas
[H, W, 3] with y flipped (the reference's ``mat[height-1-j, i]``), then
globally min-max normalized (max taken after the min subtraction) or
clipped, optionally gamma'd by 1/tonemapping, and scaled to uint8.
"""

from __future__ import annotations

import numpy as np
import torch


def radiance_to_canvas(radiance: torch.Tensor, width: int,
                       height: int) -> torch.Tensor:
    """Flat x-outer/y-inner radiance [W*H, 3] -> canvas [H, W, 3]."""
    grid = radiance.reshape(width, height, 3)  # [ix, iy, 3]
    return torch.flip(grid.permute(1, 0, 2), dims=(0,))  # [H-1-iy, ix]


def normalize_minmax(canvas: torch.Tensor) -> torch.Tensor:
    """Subtract the min, then divide by the max of the shifted canvas; a
    constant canvas maps to zeros rather than 0/0."""
    shifted = canvas - canvas.min()
    peak = shifted.max()
    return shifted / torch.where(peak == 0.0, 1.0, peak)


def radiance_to_image(
    radiance: torch.Tensor, width: int, height: int,
    normalization: str = "minmax", tonemapping: float | None = None,
) -> np.ndarray:
    """uint8 [H, W, 3] image. normalization: "minmax" (reference) | "clip".
    ``tonemapping`` > 0 and != 1 raises the normalized canvas to
    1/tonemapping."""
    canvas = radiance_to_canvas(radiance, width, height)
    if normalization == "minmax":
        canvas = normalize_minmax(canvas)
    elif normalization == "clip":
        canvas = torch.clamp(canvas, 0.0, 1.0)
    else:
        raise ValueError(normalization)
    if tonemapping is not None and tonemapping > 0.0 and tonemapping != 1.0:
        canvas = torch.pow(canvas, 1.0 / tonemapping)
    return (canvas * 255.0).cpu().numpy().astype(np.uint8)


def save_png(image: np.ndarray, path: str) -> None:
    from PIL import Image

    Image.fromarray(image).save(path)
