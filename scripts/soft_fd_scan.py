"""Scan the soft estimator's rotation gradient against central differences
over a range of yaws, in both packages, on the CPU.

    JAX_PLATFORMS=cpu python scripts/soft_fd_scan.py

The occluder scene of ``tests/test_boundary.py`` (12x12, 1 bounce, 2 NEE
samples, beta 0.05), its blocker yawed about the corner (0.4, 0, -1.6), the
loss the mean radiance: for each yaw from -0.1 to 0.3 in steps of 0.02,
autograd against the central difference with a step of 2e-3, at the
tolerances of ``test_soft_rotation_grad_matches_fd`` (rtol 8e-2, atol
2e-5), for the JAX package (jitted), the port, and the port over the
pixels whose front record does not tie (``tests/torch_boundary_parity.py:
near_tie_lanes``). A ray that misses the blocker quad near its edge has
the same t on both of its triangles, so the front record is picked by the
last bit of t, and the radiance jumps where that bit flips. Prints one
line per yaw and the failure counts.
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from pathtracerpython_tpu.diff import transforms as jax_transforms  # noqa: E402
from pathtracerpython_tpu.ops.camera import (  # noqa: E402
    make_primary_rays as jax_make_primary_rays,
)
from pathtracerpython_tpu.render.config import (  # noqa: E402
    RenderConfig as JaxConfig,
)
from pathtracerpython_tpu.render.integrator import (  # noqa: E402
    render_rays as jax_render_rays,
)
from pathtracerpython_tpu_torch.diff.transforms import (  # noqa: E402
    rotate_object,
)
from pathtracerpython_tpu_torch.ops.camera import (  # noqa: E402
    make_primary_rays,
)
from pathtracerpython_tpu_torch.render.config import (  # noqa: E402
    RenderConfig,
)
from pathtracerpython_tpu_torch.render.integrator import (  # noqa: E402
    render_rays,
)
from pathtracerpython_tpu_torch.scene import synthetic  # noqa: E402
from torch_boundary_parity import near_tie_lanes  # noqa: E402
from torch_parity import pack_pair  # noqa: E402

BETA, EPS, RTOL, ATOL = 0.05, 2e-3, 8e-2, 2e-5
CENTER = (0.4, 0.0, -1.6)
KW = dict(n_bounces=1, n_light_samples=2, soft_vis_beta=BETA)


def main() -> int:
    scene, jax_scene = pack_pair(synthetic.occluder_scene())
    n = scene.meta.width * scene.meta.height
    jo, jd = jax_make_primary_rays(jax_scene.eye, jax_scene.ortho, 12, 12)
    pids = jnp.arange(n, dtype=jnp.int32)
    po, pd = make_primary_rays(scene.eye, scene.ortho, 12, 12)

    def jax_loss(th):
        moved = jax_transforms.rotate_object(jax_scene, 1, th, center=CENTER)
        return jnp.mean(jax_render_rays(jo, jd, pids, moved, JaxConfig(
            mode="fast", **KW), 0))

    jax_vg = jax.jit(jax.value_and_grad(jax_loss))
    jax_f = jax.jit(jax_loss)

    def port_radiance(th):
        moved = rotate_object(scene, 1, th, center=CENTER)
        return render_rays(po, pd, torch.arange(n), moved,
                           RenderConfig(**KW), 0).mean(dim=1)

    def port_check(th0, keep):
        def f(th):
            return (port_radiance(th) * keep).sum() / keep.sum()

        x = torch.tensor(th0, requires_grad=True)
        f(x).backward()
        with torch.no_grad():
            fd = float((f(torch.tensor(th0 + EPS))
                        - f(torch.tensor(th0 - EPS))) / (2 * EPS))
        return float(x.grad), fd

    def ok(ad, fd):
        return abs(ad - fd) <= ATOL + RTOL * abs(fd)

    fails = {"jax": 0, "port": 0, "port, ties left out": 0}
    for th0 in np.arange(-0.1, 0.31, 0.02):
        th0 = float(np.float32(th0))
        _, g = jax_vg(th0)
        jad = float(g)
        jfd = (float(jax_f(th0 + EPS)) - float(jax_f(th0 - EPS))) / (2 * EPS)
        pad, pfd = port_check(th0, torch.ones(n))
        tie = np.zeros(n, bool)
        with torch.no_grad():
            for th in (th0 - EPS, th0, th0 + EPS):
                moved = rotate_object(scene, 1, torch.tensor(th),
                                      center=CENTER)
                tie |= near_tie_lanes(po.numpy(), pd.numpy(), moved,
                                      BETA)["f"]
        tad, tfd = port_check(th0, torch.from_numpy(~tie).float())
        row = []
        for name, ad, fd in (("jax", jad, jfd), ("port", pad, pfd),
                             ("port, ties left out", tad, tfd)):
            fails[name] += not ok(ad, fd)
            row.append(f"{name} ad {ad:+.5f} fd {fd:+.5f} "
                       f"{'ok' if ok(ad, fd) else 'FAIL'}")
        print(f"yaw {th0:+.2f} ({int(tie.sum())} tied pixels): "
              + " | ".join(row), flush=True)
    print("failures of 21:", fails)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
