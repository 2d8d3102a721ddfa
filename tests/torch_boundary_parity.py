"""Shared helpers of the soft-visibility parity tests: seeded rays, the JAX
package's soft records as numpy, and the near-tie rule for holding the
port's records against them.

Both packages run the same float32 plane solve, but XLA:CPU may fuse a
product into an add where PyTorch does not, so a pair's t or margin can
differ in the last places of its intermediates, whose size is the scene's
coordinates: measured up to 1.1e-6 on random triangles in [-2, 2] and
4.1e-6 on the Cornell stand-in (coordinates up to 32.8). So t and margin
are held within rtol T_RTOL and atol T_ATOL per unit of the scene's extent
(its largest absolute coordinate, at least 1) where the indices agree.
Where two triangles' keys tie within that, the winner may differ, so
indices are held equal except on lanes whose winning key leads its
runner-up by at most TIE_RTOL relative (a quad's two triangles share a
plane, and so do a box field's coplanar faces)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import torch

from pathtracerpython_tpu.diff import boundary as jb
from pathtracerpython_tpu_torch.diff import boundary as pb

T_RTOL = T_ATOL = 1e-6
TIE_RTOL = 1e-6
IDX_FIELDS = (("f_t", "f_idx", "f_margin"), ("h1_t", "h1_idx", None),
              ("h2_t", "h2_idx", None))


def seeded_rays(n: int, lo, hi, seed: int = 0):
    """(origins, directions) f32[n, 3] as numpy: origins uniform in the box
    [lo, hi], directions normal (not unit)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


def jax_records(records) -> dict[str, np.ndarray]:
    return {f: np.asarray(getattr(records, f)) for f in records._fields}


def port_records(records) -> dict[str, np.ndarray]:
    return {f: getattr(records, f).detach().numpy()
            for f in records._fields}


def _smallest(keys: torch.Tensor, k: int) -> torch.Tensor:
    return torch.topk(keys, k, dim=1, largest=False).values


def near_tie_lanes(origins, directions, scene, beta: float,
                   chunk: int = 128) -> dict[str, np.ndarray]:
    """Per record, bool[N]: the lanes whose winner could flip between the
    packages. F: its biased key within TIE_RTOL of the runner-up's; hit1:
    the two smallest true-hit t within it; hit2: hit1's tie or the second
    and third true-hit t within it. Every pair of the scene, with the
    port's plane solve, in chunks of ``chunk`` rays."""
    o = torch.from_numpy(np.asarray(origins))
    d = pb.safe_normalize(torch.from_numpy(np.asarray(directions)))
    band = pb.BAND_SIGMAS * beta
    v = [getattr(scene, f) for f in ("tri_v0", "tri_v1", "tri_v2")]
    out = {"f": [], "h1": [], "h2": []}
    inf = float("inf")
    for s in range(0, o.shape[0], chunk):
        ok, t, margin = pb.plane_hit_and_margin(
            o[s:s + chunk, None], d[s:s + chunk, None],
            *(x[None] for x in v))
        base = ok & scene.tri_valid[None] & (t > pb.T_MIN)
        true_t = _smallest(torch.where(base & (margin >= 0), t, inf), 3)
        f_key = _smallest(torch.where(base & (margin > -band),
                                      pb._f_key(t, margin), inf), 2)

        def tie(a, b):
            return (b - a <= TIE_RTOL * a.abs()) & torch.isfinite(a)

        h1 = tie(true_t[:, 0], true_t[:, 1])
        out["f"].append(tie(f_key[:, 0], f_key[:, 1]))
        out["h1"].append(h1)
        out["h2"].append(h1 | tie(true_t[:, 1], true_t[:, 2]))
    return {k: torch.cat(x).numpy() for k, x in out.items()}


def extent(*arrays) -> float:
    """The largest absolute coordinate of the arrays, at least 1."""
    return max([1.0] + [float(np.abs(np.asarray(a)).max()) for a in arrays])


def hold_records(got: dict, want: dict, ties: dict,
                 scale: float) -> dict[str, int]:
    """Indices equal on every lane but the near ties; t and margin within
    T_RTOL and T_ATOL * ``scale`` (the scene's ``extent``) where the
    indices agree and a record was found. Returns the number of lanes that
    differ per index, all of them ties."""
    differ = {}
    for (t_f, i_f, m_f), tie in zip(IDX_FIELDS, ("f", "h1", "h2")):
        bad = got[i_f] != want[i_f]
        assert not (bad & ~ties[tie]).any(), (
            i_f, np.nonzero(bad & ~ties[tie])[0][:10])
        differ[i_f] = int(bad.sum())
        same = ~bad & (want[i_f] != jb.IMAX)
        np.testing.assert_allclose(got[t_f][same], want[t_f][same],
                                   rtol=T_RTOL, atol=T_ATOL * scale,
                                   err_msg=t_f)
        if m_f is not None:
            np.testing.assert_allclose(got[m_f][same], want[m_f][same],
                                       rtol=T_RTOL, atol=T_ATOL * scale,
                                       err_msg=m_f)
    return differ


def jax_arrays(*xs):
    return [jnp.asarray(x) for x in xs]
