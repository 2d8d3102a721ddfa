"""A field of jittered boxes over a floor under a small ceiling light: box
centres and half sizes drawn uniformly from numpy's PCG64 generator under
the configuration's seed, 12 triangles a box, one material for all boxes;
12 * n_boxes + 4 triangles."""

from __future__ import annotations

import numpy as np

from benchmark.scenes import RawObject, RawScene, box, quad


def build(p: dict) -> RawScene:
    e = p["extent"]
    n = p["n_boxes"]
    rng = np.random.default_rng(p["seed"])
    centers = rng.uniform([-e, -0.8, -2 * e], [e, 0.8, -0.5], (n, 3))
    halves = rng.uniform(0.05, 0.25, (n, 3))
    verts, faces = [], []
    for i, (c, h) in enumerate(zip(centers, halves)):
        v, f = box(c, h)
        verts.append(v)
        faces.append(f + 8 * i)
    fv, ff = quad([-e, -1.0, 0.5], [e, -1.0, 0.5], [e, -1.0, -2 * e],
                  [-e, -1.0, -2 * e])
    lv, lf = quad([-0.6, 1.4, -e], [0.6, 1.4, -e], [0.6, 1.4, -e + 1.2],
                  [-0.6, 1.4, -e + 1.2])
    objects = [
        RawObject("floor", fv, ff, tuple(p["floor_rgb"]), **p["floor_material"]),
        RawObject("boxes", np.concatenate(verts), np.concatenate(faces),
                  tuple(p["box_rgb"]), **p["box_material"]),
    ]
    return RawScene(objects=objects, light_vertices=lv, light_faces=lf,
                    light_color=tuple(p["light_color"]), eye=tuple(p["eye"]),
                    ortho=tuple(p["ortho"]), width=p["width"],
                    height=p["height"], ambient=p["ambient"])
