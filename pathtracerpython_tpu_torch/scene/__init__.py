"""Scene I/O: SDL + OBJ parsing into flat, padded SoA tensors."""

from pathtracerpython_tpu_torch.scene.obj import ObjMesh, load_obj  # noqa: F401
from pathtracerpython_tpu_torch.scene.sdl import SceneDescription, load_sdl  # noqa: F401
from pathtracerpython_tpu_torch.scene.arrays import (  # noqa: F401
    SceneMeta,
    SceneTensors,
    from_jax_scene,
    load_scene,
    pack_scene,
    recompute_derived,
)
