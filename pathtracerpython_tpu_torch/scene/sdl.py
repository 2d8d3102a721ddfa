"""SDL scene-description parser.

Same contract as ``pathtracerpython_tpu/scene/sdl.py``: records ``eye``,
``size``, ``ortho``, ``background``, ``ambient``, ``light <obj> r g b``,
``npaths``, ``tonemapping``, ``seed``, ``object <obj> r g b ka kd ks kt n``,
``output``. OBJ paths are resolved relative to the SDL file's directory and
read by ``scene/native.py:load_obj_fast`` (the native parser where its
library builds, the Python parser otherwise), as the JAX package reads
them; unknown records are skipped.
"""

from __future__ import annotations

import dataclasses
import os

from pathtracerpython_tpu_torch.scene.native import load_obj_fast as load_obj
from pathtracerpython_tpu_torch.scene.obj import ObjMesh, strip_comments


@dataclasses.dataclass
class SdlObject:
    """One ``object`` record: geometry + flat material."""

    mesh: ObjMesh
    rgb: tuple[float, float, float]
    ka: float
    kd: float
    ks: float
    kt: float
    n: float


@dataclasses.dataclass
class SceneDescription:
    """Parsed SDL scene (host-side; see arrays.py for the device layout)."""

    eye: tuple[float, float, float] | None = None
    width: int | None = None
    height: int | None = None
    ortho: tuple[float, float, float, float] | None = None
    background: tuple[float, float, float] | None = None
    ambient: float | None = None
    light_mesh: ObjMesh | None = None
    light_color: tuple[float, float, float] | None = None
    npaths: int | None = None
    tonemapping: float | None = None
    seed: int | None = None
    objects: list[SdlObject] = dataclasses.field(default_factory=list)
    output: str | None = None
    path: str = ""


def load_sdl(path: str) -> SceneDescription:
    with open(path, "r") as f:
        lines = strip_comments(f.readlines())
    base = os.path.dirname(path)
    scene = SceneDescription(path=path)

    for line in lines:
        tokens = [t for t in line.split(" ") if t not in ("", " ")]
        if not tokens:
            continue
        cmd, args = tokens[0], tokens[1:]
        if cmd == "eye":
            scene.eye = tuple(float(t) for t in args[:3])
        elif cmd == "size":
            scene.width, scene.height = int(args[0]), int(args[1])
        elif cmd == "ortho":
            scene.ortho = tuple(float(t) for t in args[:4])
        elif cmd == "background":
            scene.background = tuple(float(t) for t in args[:3])
        elif cmd == "ambient":
            scene.ambient = float(args[0])
        elif cmd == "light":
            scene.light_mesh = load_obj(os.path.join(base, args[0]))
            scene.light_color = tuple(float(t) for t in args[1:4])
        elif cmd == "npaths":
            scene.npaths = int(args[0])
        elif cmd == "tonemapping":
            scene.tonemapping = float(args[0])
        elif cmd == "seed":
            scene.seed = int(args[0])
        elif cmd == "object":
            scene.objects.append(
                SdlObject(
                    mesh=load_obj(os.path.join(base, args[0])),
                    rgb=(float(args[1]), float(args[2]), float(args[3])),
                    ka=float(args[4]),
                    kd=float(args[5]),
                    ks=float(args[6]),
                    kt=float(args[7]),
                    n=float(args[8]),
                )
            )
        elif cmd == "output":
            scene.output = os.path.join(base, args[0])
        # unknown records are skipped, as in the reference
    return scene
