"""Offline 3-D scene debug plots, a copy of the JAX package's
``viz/plot.py`` for ``SceneTensors``.

Feature parity with the reference's viewer (its ``plot.py:28-105``) as a
static matplotlib render saved to disk instead of a blocking Qt window:
triangle wireframes (:67-76), per-triangle normals (:55-64), the camera
point (:79-84), screen points coloured by pixel colour (:86-89), and
first-hit points (:98-105). matplotlib is imported when a plot is made;
where it is missing (the card's machine has none) ``plot_scene`` raises
an ``ImportError`` that says so.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "the debug views (--show-scene, --show-normals, --show-screen, "
            "--show-inter) need matplotlib, which is not installed"
        ) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_scene(
    scene,
    out_path: str,
    show_normals: bool = False,
    show_screen: bool = False,
    screen_colors=None,
    intersections=None,
    rays=None,
    ray_length: float = 8.0,
    elev: float = 20.0,
    azim: float = -60.0,
) -> str:
    """Render a debug view of the ``SceneTensors`` to ``out_path`` (PNG).

    ``screen_colors``: optional [W*H, 3] radiance for the screen scatter.
    ``intersections``: optional [N, 3] first-hit points.
    ``rays``: optional (origins [N,3], directions [N,3]) drawn as segments
    (the reference's ray overlay, ``plot.py:92-95``).
    Returns ``out_path``.
    """
    plt = _pyplot()
    fig = plt.figure(figsize=(9, 9))
    ax = fig.add_subplot(111, projection="3d")

    v0 = _np(scene.tri_v0)
    v1 = _np(scene.tri_v1)
    v2 = _np(scene.tri_v2)
    valid = _np(scene.tri_valid)
    is_light = _np(scene.tri_is_light)

    for a, b, c, ok, lit in zip(v0, v1, v2, valid, is_light):
        if not ok:
            continue
        loop = np.stack([a, b, c, a])
        ax.plot(loop[:, 0], loop[:, 2], loop[:, 1],
                color="orange" if lit else "gray", linewidth=0.8)

    if show_normals:
        normals = _np(scene.tri_normal)
        centers = (v0 + v1 + v2) / 3.0
        for ctr, n, ok in zip(centers, normals, valid):
            if not ok:
                continue
            tip = ctr + 0.25 * n
            ax.plot([ctr[0], tip[0]], [ctr[2], tip[2]], [ctr[1], tip[1]],
                    color="red", linewidth=0.6)

    eye = _np(scene.eye)
    ax.scatter([eye[0]], [eye[2]], [eye[1]], color="blue", s=40,
               label="camera")

    if show_screen:
        from pathtracerpython_tpu_torch.ops.camera import make_screen_points

        pts = _np(make_screen_points(
            scene.ortho, scene.meta.width, scene.meta.height
        ))
        if screen_colors is not None:
            col = _np(screen_colors)
            col = np.clip(col / max(col.max(), 1e-6), 0.0, 1.0)
        else:
            col = "green"
        ax.scatter(pts[:, 0], pts[:, 2], pts[:, 1], c=col, s=1)

    if rays is not None:
        ro, rd = (_np(r) for r in rays)
        norm = np.linalg.norm(rd, axis=-1, keepdims=True)
        tips = ro + rd / np.maximum(norm, 1e-12) * ray_length
        for a, b in zip(ro, tips):
            ax.plot([a[0], b[0]], [a[2], b[2]], [a[1], b[1]],
                    color="cyan", linewidth=0.3, alpha=0.5)

    if intersections is not None:
        ip = _np(intersections)
        ax.scatter(ip[:, 0], ip[:, 2], ip[:, 1], color="purple", s=2,
                   label="hits")

    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.set_zlabel("y")
    ax.view_init(elev=elev, azim=azim)
    ax.legend(loc="upper right")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
