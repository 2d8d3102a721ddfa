"""The raw scenes the benchmark makes: each kind is a module of this
package with ``build(params) -> RawScene``, found by the ``kind`` a
configuration file names. Both sides get the same raw arrays: the program
through its own scene constructors (``program_scene``), the plain reference
through ``reference.build_scene``."""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np


@dataclasses.dataclass
class RawObject:
    name: str
    vertices: np.ndarray  # float64 [V, 3]
    faces: np.ndarray     # int32 [F, 3]
    rgb: tuple
    ka: float
    kd: float
    ks: float
    kt: float
    n: float


@dataclasses.dataclass
class RawScene:
    objects: list
    light_vertices: np.ndarray
    light_faces: np.ndarray
    light_color: tuple
    eye: tuple
    ortho: tuple
    width: int
    height: int
    ambient: float
    background: tuple = (0.0, 0.0, 0.0)

    @property
    def n_triangles(self) -> int:
        return (sum(len(o.faces) for o in self.objects)
                + len(self.light_faces))


def box(center, half) -> tuple[np.ndarray, np.ndarray]:
    """An axis-aligned box: 8 corners and 12 triangles wound outward."""
    corners = np.asarray([[-1, -1, -1], [1, -1, -1], [1, -1, 1], [-1, -1, 1],
                          [-1, 1, -1], [1, 1, -1], [1, 1, 1], [-1, 1, 1]],
                         np.float64)
    faces = np.asarray([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6],
                        [0, 4, 5], [0, 5, 1], [3, 2, 6], [3, 6, 7],
                        [1, 5, 6], [1, 6, 2], [0, 3, 7], [0, 7, 4]], np.int32)
    c = np.asarray(center, np.float64)
    h = np.asarray(half, np.float64)
    return c + corners * h, faces


def quad(p0, p1, p2, p3) -> tuple[np.ndarray, np.ndarray]:
    return (np.asarray([p0, p1, p2, p3], np.float64),
            np.asarray([[0, 1, 2], [0, 2, 3]], np.int32))


def build(scene_cfg: dict) -> RawScene:
    """The raw scene a configuration's ``scene`` entry names by ``kind``."""
    module = importlib.import_module(f"benchmark.scenes.{scene_cfg['kind']}")
    return module.build(scene_cfg)


def program_scene(raw: RawScene, scene_cfg: dict, device):
    """The system's packed scene of the raw arrays, through its public
    constructors, packed as the configuration says."""
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.obj import mesh_from_arrays
    from pathtracerpython_tpu_torch.scene.sdl import (
        SceneDescription,
        SdlObject,
    )

    objects = [SdlObject(mesh=mesh_from_arrays(o.vertices, o.faces,
                                               path=o.name),
                         rgb=tuple(o.rgb), ka=o.ka, kd=o.kd, ks=o.ks,
                         kt=o.kt, n=o.n) for o in raw.objects]
    desc = SceneDescription(
        eye=tuple(raw.eye), width=raw.width, height=raw.height,
        ortho=tuple(raw.ortho), background=tuple(raw.background),
        ambient=raw.ambient,
        light_mesh=mesh_from_arrays(raw.light_vertices, raw.light_faces,
                                    path="light"),
        light_color=tuple(raw.light_color), objects=objects,
        path=f"benchmark://{scene_cfg['kind']}")
    return pack_scene(desc, pad_to=scene_cfg.get("pad_to", 128),
                      tri_order=scene_cfg.get("tri_order"), device=device)
