"""Radiance -> image conversion, as the JAX package's ``render/image.py``.

The flat x-outer / y-inner radiance [W*H, 3] is laid out as a canvas
[H, W, 3] with y flipped (the reference's ``mat[height-1-j, i]``), then
globally min-max normalized (max taken after the min subtraction) or
clipped, optionally gamma'd by 1/tonemapping, and scaled to uint8.
``save_png`` writes the PNG with the standard library (``zlib`` and
``struct``), and ``read_png`` reads one back (8-bit, not interlaced, any
filter): the card's machine may have no PIL.
"""

from __future__ import annotations

import struct
import zlib

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


# PNG colour types by channel count: grey, RGB, RGBA
_COLOR_TYPES = {1: 0, 3: 2, 4: 6}


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def save_png(image: np.ndarray, path: str) -> None:
    """Write a uint8 image [H, W], [H, W, 3] or [H, W, 4] as an 8-bit PNG:
    one IDAT of scanlines with filter type 0 (none), zlib level 6. PIL
    decodes it to the pixels PIL itself would have written."""
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"save_png takes uint8 images, not {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPES:
        raise ValueError(f"save_png takes [H, W(, 3|4)], not {image.shape}")
    h, w, c = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * c)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _unfilter(kind: int, line: np.ndarray, prior: np.ndarray,
              bpp: int) -> np.ndarray:
    """One scanline of a PNG with its filter (0-4) undone."""
    out = line.astype(np.int32)
    up = prior.astype(np.int32)
    if kind == 0:
        return out
    if kind == 2:
        return (out + up) & 0xFF
    for i in range(len(out)):
        left = out[i - bpp] if i >= bpp else 0
        if kind == 1:
            pred = left
        elif kind == 3:
            pred = (left + up[i]) // 2
        elif kind == 4:
            upleft = up[i - bpp] if i >= bpp else 0
            p = left + up[i] - upleft
            pa, pb, pc = abs(p - left), abs(p - up[i]), abs(p - upleft)
            pred = left if pa <= pb and pa <= pc else (
                up[i] if pb <= pc else upleft)
        else:
            raise ValueError(f"PNG filter type {kind}")
        out[i] = (out[i] + pred) & 0xFF
    return out


def read_png(path: str) -> np.ndarray:
    """The uint8 pixels [H, W] or [H, W, C] of an 8-bit, non-interlaced
    grey, RGB or RGBA PNG, such as ``save_png`` and PIL write."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, color, _, _, interlace = header
    channels = {v: k for k, v in _COLOR_TYPES.items()}.get(color)
    if depth != 8 or interlace != 0 or channels is None:
        raise ValueError(f"{path}: only 8-bit, non-interlaced grey, RGB "
                         "and RGBA PNGs are read")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = raw.reshape(h, 1 + w * channels)
    out = np.zeros((h, w * channels), np.uint8)
    prior = np.zeros(w * channels, np.uint8)
    for y in range(h):
        prior = _unfilter(int(rows[y, 0]), rows[y, 1:], prior,
                          channels).astype(np.uint8)
        out[y] = prior
    img = out.reshape(h, w, channels)
    return img[:, :, 0] if channels == 1 else img
