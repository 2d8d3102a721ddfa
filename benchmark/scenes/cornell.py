"""The Cornell box in the layout of the upstream ``objs/cornellroom.sdl``:
red left and green right walls, white floor, ceiling and back, a tall cube
(ks 0.9) and a short one (ks 0.6), and a two-triangle light hung 0.84 below
the ceiling; 36 triangles. Every size is a parameter of the configuration
file."""

from __future__ import annotations

from benchmark.scenes import RawObject, RawScene, box, quad


def build(p: dict) -> RawScene:
    x, y, z = p["room"]
    ly = p["light_y"]
    lx0, lx1, lz0, lz1 = p["light_rect"]
    walls = {
        "leftwall": quad([-x, -y, 0], [-x, -y, z], [-x, y, z], [-x, y, 0]),
        "rightwall": quad([x, -y, z], [x, -y, 0], [x, y, 0], [x, y, z]),
        "floor": quad([-x, -y, 0], [x, -y, 0], [x, -y, z], [-x, -y, z]),
        "ceiling": quad([-x, y, z], [x, y, z], [x, y, 0], [-x, y, 0]),
        "back": quad([-x, -y, z], [x, -y, z], [x, y, z], [-x, y, z]),
    }
    objects = []
    for name, rgb in p["walls"]:
        v, f = walls[name]
        objects.append(RawObject(name, v, f, tuple(rgb), **p["wall_material"]))
    for c in p["cubes"]:
        center = [c["center"][0], -y + c["half"][1], c["center"][2]]
        v, f = box(center, c["half"])
        objects.append(RawObject(c["name"], v, f, tuple(c["rgb"]),
                                 **c["material"]))
    lv, lf = quad([lx0, ly, lz0], [lx1, ly, lz0], [lx1, ly, lz1],
                  [lx0, ly, lz1])
    return RawScene(objects=objects, light_vertices=lv, light_faces=lf,
                    light_color=tuple(p["light_color"]), eye=tuple(p["eye"]),
                    ortho=tuple(p["ortho"]), width=p["width"],
                    height=p["height"], ambient=p["ambient"],
                    background=tuple(p.get("background", (0.0, 0.0, 0.0))))
