"""The plain reference of the benchmark: a path tracer in plain PyTorch.

It imports nothing of the system under test and takes nothing it made. From
the raw scene the benchmark builds (``scenes.RawScene``: vertices, faces,
materials, light, camera) it works out again every derived table, the
Threefry stream and its chunk seeds, the primary rays, both sweeps and both
estimators of the renderer:

- ``fast``: the hard estimator: nearest hit (Moller-Trumbore, t > 1e-4),
  ambient plus next-event estimation (area-proportional light pick,
  sqrt-trick barycentrics, clamped cosine about the arrival-side normal,
  occlusion by object triangles with t < dist - 1e-4), light hits paid only
  from the camera or after a specular bounce, and cosine-weighted diffuse
  or mirror scattering chosen with probability kd / (kd + ks);
- ``reference``: the upstream program's estimator with its quirks (signed
  plane distances, sign-only inside test, centre-biased barycentrics,
  unclamped cosine on the winding normal, the colour of the last light
  sample's first occluder, frames rotated about the fixed y axis, a Phong
  factor toward the eye, 2*pi truncated to 6.28).

The random stream is Threefry-2x32 (Salmon et al. 2011) with 20 rounds, keyed
per path by the global path id ``pixel * spp + sample``, so any subset of
pixels can be traced alone: the reference traces only the pixels it checks.
Sweeps are dense (every lane against every triangle, in tiles) and run only
the lanes still alive, so the reference stays plain at any scene size.

``dtype`` is the precision of every float: float32 as the configurations
state, bfloat16 for the control, which has to come out as not correct.

The fit reference (``fit_steps``) differentiates the fast estimator by
autograd: the sweeps' winners and occlusion are discrete, and each winner's
distance is solved again with autograd from its own triangle; its Adam is
written out here.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
FOLD_WORD = 0x736F6C74
T_MIN = 1e-4          # fast mode: near clip, and the shadow ray's slack
DET_EPS = 1e-7        # fast mode: |det| above this is not parallel
REF_EPS = 1e-5        # reference mode: parallel rejection and self-hit
TAU = 2.0 * math.pi
TAU_UPSTREAM = 6.28
TILE = 1024           # triangles a sweep step holds
ELEMENTS = 1 << 22    # lane-triangle pairs a sweep step holds


# ----------------------------------------------------------------------
# Threefry-2x32 and the key schedule
# ----------------------------------------------------------------------

def _rotl(x, r):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry(k0: int, k1: int, x0, x1):
    """Threefry-2x32, 20 rounds, of counter words (x0, x1) under the key
    (k0, k1); ints or int64 tensors of 32-bit words."""
    ks = (k0 & MASK, k1 & MASK, (k0 ^ k1 ^ PARITY) & MASK)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key_of(seed: int) -> tuple[int, int]:
    """The key of an integer seed: its high and low 32-bit words."""
    return (seed >> 32) & MASK, seed & MASK


def fold_in(key, data: int) -> tuple[int, int]:
    return threefry(*key, 0, data & MASK)


def split(key) -> tuple[tuple[int, int], tuple[int, int]]:
    return threefry(*key, 0, 0), threefry(*key, 0, 1)


def derive(key, salt: int) -> tuple[int, int]:
    """The per-bounce sub-key: the salt hashed under the key."""
    return threefry(*key, salt & MASK, FOLD_WORD)


def randint31(key) -> int:
    """A uniform integer in [0, 2^31 - 1) from a key, as a counter-based
    generator draws one: two sub-keys, 32 bits from each (the xor of the
    hash of (0, 0)), combined modulo the span in 32-bit arithmetic."""
    span = 2**31 - 1

    def bits(k):
        y0, y1 = threefry(*k, 0, 0)
        return y0 ^ y1

    hi, lo = (bits(k) for k in split(key))
    mult = (2**16 % span) & MASK
    mult = ((mult * mult) & MASK) % span
    off = ((((hi % span) * mult) & MASK) + lo % span) & MASK
    return off % span


def chunk_seed(seed: int, chunk: int) -> int:
    """The seed of sample chunk ``chunk`` of a progressive render."""
    return randint31(fold_in(key_of(seed), chunk))


def uniforms(key, counters: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """[n, N] uniforms in [0, 1): draws 2j and 2j + 1 of a path are the two
    words of the hash of (path id, j), a word's top 23 bits the mantissa."""
    c = counters.to(torch.int64) & MASK
    out = []
    for j in range((n + 1) // 2):
        for word in threefry(*key, c, j):
            f = ((word >> 9) | 0x3F800000).to(torch.int32)
            out.append(f.view(torch.float32) - 1.0)
    return torch.stack(out[:n]).to(dtype)


# ----------------------------------------------------------------------
# The scene, worked out again from the raw arrays
# ----------------------------------------------------------------------

@dataclass
class Scene:
    """Triangles in object order, then the light's; rows are [T, 3]."""

    v0: torch.Tensor
    v1: torch.Tensor
    v2: torch.Tensor
    normal: torch.Tensor     # unit winding normal
    material: torch.Tensor   # int64 [T]
    is_light: torch.Tensor   # bool [T]
    rgb: torch.Tensor        # [M, 3], the light's row last
    ka: torch.Tensor
    kd: torch.Tensor
    ks: torch.Tensor
    phong: torch.Tensor
    lv0: torch.Tensor        # the light's triangles [L, 3]
    lv1: torch.Tensor
    lv2: torch.Tensor
    light_area: torch.Tensor
    light_rows: torch.Tensor  # int64 [L]: the light's rows among the triangles
    light_color: torch.Tensor
    ambient: torch.Tensor
    eye: torch.Tensor
    ortho: torch.Tensor
    width: int
    height: int
    n_objects: int

    @property
    def dtype(self):
        return self.v0.dtype

    @property
    def device(self):
        return self.v0.device


def build_scene(raw, device, dtype=torch.float32) -> Scene:
    """The reference's tables from a ``scenes.RawScene``: vertices rounded
    from float64, normals and areas from the float64 vertices."""
    v0s, v1s, v2s, mats, light = [], [], [], [], []
    meshes = [(o.vertices, o.faces, i, False)
              for i, o in enumerate(raw.objects)]
    meshes.append((raw.light_vertices, raw.light_faces, len(raw.objects),
                   True))
    for verts, faces, mat, is_light in meshes:
        tri = np.asarray(verts, np.float64)[np.asarray(faces, np.int64)]
        v0s.append(tri[:, 0]); v1s.append(tri[:, 1]); v2s.append(tri[:, 2])
        mats.append(np.full(len(faces), mat))
        light.append(np.full(len(faces), is_light))
    v0, v1, v2 = (np.concatenate(v) for v in (v0s, v1s, v2s))
    cross = np.cross(v1 - v0, v2 - v0)
    norm = np.linalg.norm(cross, axis=1)
    normal = cross / np.where(norm == 0.0, 1.0, norm)[:, None]
    is_light = np.concatenate(light)
    rows = np.nonzero(is_light)[0]

    def t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), device=device).to(dt)

    objs = raw.objects
    return Scene(
        v0=t(v0), v1=t(v1), v2=t(v2), normal=t(normal),
        material=t(np.concatenate(mats), torch.int64),
        is_light=t(is_light, torch.bool),
        rgb=t([list(o.rgb) for o in objs] + [[0.0, 0.0, 0.0]]),
        ka=t([o.ka for o in objs] + [0.0]),
        kd=t([o.kd for o in objs] + [0.0]),
        ks=t([o.ks for o in objs] + [0.0]),
        phong=t([o.n for o in objs] + [1.0]),
        lv0=t(v0[rows]), lv1=t(v1[rows]), lv2=t(v2[rows]),
        light_area=t(norm[rows] / 2.0),
        light_rows=t(rows, torch.int64),
        light_color=t(raw.light_color), ambient=t(raw.ambient),
        eye=t(raw.eye), ortho=t(raw.ortho),
        width=raw.width, height=raw.height, n_objects=len(objs),
    )


def primary_rays(scene: Scene, pixels: torch.Tensor):
    """(origins, directions) [N, 3] of flat pixel ids, x the outer index:
    the screen point (x, y, 0) on an inclusive grid over the ortho window,
    from the eye; directions not normalized."""
    h, w = scene.height, scene.width
    ix = (pixels // h).double()
    iy = (pixels % h).double()
    o = scene.ortho.double()
    x = o[0] + (o[2] - o[0]) * ix / max(w - 1, 1)
    y = o[1] + (o[3] - o[1]) * iy / max(h - 1, 1)
    pts = torch.stack([x, y, torch.zeros_like(x)], dim=1).to(scene.dtype)
    origins = scene.eye.expand(pts.shape[0], 3)
    return origins, pts - scene.eye


# ----------------------------------------------------------------------
# Vector helpers (row-major [N, 3])
# ----------------------------------------------------------------------

def dot(a, b):
    return (a * b).sum(dim=-1)


def unit(v):
    return v * torch.rsqrt(torch.clamp_min(dot(v, v), 1e-30))[..., None]


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


# ----------------------------------------------------------------------
# Dense sweeps, on component triples of [lanes, 1] and [1, triangles]
# ----------------------------------------------------------------------

def _c(v):
    """The component triple of [..., 3] rows."""
    return v[..., 0], v[..., 1], v[..., 2]


def _sub(a, b):
    return a[0] - b[0], a[1] - b[1], a[2] - b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _moller(o, d, v0, e1, e2):
    """(hit, t) of Moller-Trumbore on component triples, broadcast."""
    p = _cross(d, e2)
    det = _dot(e1, p)
    ok = det.abs() > DET_EPS
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    s = _sub(o, v0)
    u = _dot(s, p) * inv
    q = _cross(s, e1)
    v = _dot(d, q) * inv
    t = _dot(e2, q) * inv
    return ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > T_MIN), t


def moller(o, d, v0, v1, v2):
    """(hit, t) of rays [..., 3] against triangles [..., 3]."""
    v0 = _c(v0)
    return _moller(_c(o), _c(d), v0, _sub(_c(v1), v0), _sub(_c(v2), v0))


def _upstream(o, d, a, b, c):
    """(hit, t) of the upstream program on component triples: signed
    distance to the plane, no test of its sign, and a sign-only inside test
    of the edge crosses."""
    ab, cb = _sub(a, b), _sub(c, b)
    n = _cross(ab, cb)
    inv_len = torch.rsqrt(torch.clamp_min(_dot(n, n), 1e-30))
    n = (n[0] * inv_len, n[1] * inv_len, n[2] * inv_len)
    den = _dot(d, n)
    ok = den.abs() > REF_EPS
    t = (_dot(n, a) - _dot(n, o)) / torch.where(ok, den, torch.ones_like(den))
    p = (o[0] + d[0] * t, o[1] + d[1] * t, o[2] + d[2] * t)
    c1 = _cross(ab, _sub(p, b))
    c2 = _cross(_sub(b, c), _sub(p, c))
    c3 = _cross(_sub(c, a), _sub(p, a))
    return ok & (_dot(c1, c2) > 0) & (_dot(c1, c3) > 0), t


def _tiles(n, step):
    return [(i, min(i + step, n)) for i in range(0, n, step)]


def _sweep(scene: Scene, o, d, mode: str, visit):
    """Every lane (o, d unit) [N, 3] against every triangle, in tiles:
    ``visit(lo, hi, a, b, hit, t)`` for lanes [lo, hi) and rows [a, b)."""
    n = o.shape[0]
    for a, b in _tiles(scene.v0.shape[0], TILE):
        v0, v1, v2 = (tuple(x[None] for x in _c(v[a:b]))
                      for v in (scene.v0, scene.v1, scene.v2))
        e1, e2 = _sub(v1, v0), _sub(v2, v0)
        step = max(1, ELEMENTS // (b - a))
        for lo, hi in _tiles(n, step):
            oc = tuple(x[:, None] for x in _c(o[lo:hi]))
            dc = tuple(x[:, None] for x in _c(d[lo:hi]))
            if mode == "fast":
                hit, t = _moller(oc, dc, v0, e1, e2)
            else:
                hit, t = _upstream(oc, dc, v0, v1, v2)
            visit(lo, hi, a, b, hit, t)


@torch.no_grad()
def nearest(scene: Scene, o, d, mode: str):
    """(found, t, row) of the closest hit of rays (o, d unit) [N, 3]; ties
    go to the lowest row. Fast mode keys t (> 1e-4); upstream mode keys t^2
    (> 1e-5), so hits behind the origin count."""
    n = o.shape[0]
    big = torch.finfo(torch.float32).max
    key = torch.full((n,), big, dtype=torch.float32, device=o.device)
    t_best = torch.zeros(n, dtype=o.dtype, device=o.device)
    row = torch.zeros(n, dtype=torch.int64, device=o.device)

    def visit(lo, hi, a, b, hit, t):
        k = t.float() if mode == "fast" else (t * t).float()
        if mode != "fast":
            hit = hit & (k > REF_EPS)
        k = torch.where(hit, k, big)
        arg = k.argmin(dim=1, keepdim=True)
        kmin = k.gather(1, arg)[:, 0]
        better = kmin < key[lo:hi]
        key[lo:hi] = torch.where(better, kmin, key[lo:hi])
        t_best[lo:hi] = torch.where(better, t.gather(1, arg)[:, 0],
                                    t_best[lo:hi])
        row[lo:hi] = torch.where(better, arg[:, 0] + a, row[lo:hi])

    _sweep(scene, o, d, mode, visit)
    return key < big, t_best, row


@torch.no_grad()
def blocked(scene: Scene, o, d, dist, mode: str, first: bool = False):
    """Whether an object triangle blocks each shadow ray (o, d unit)
    within ``dist``: fast mode t < dist - 1e-4, upstream mode t^2 in
    [1e-5, dist^2). With ``first``, the lowest blocking row (-1: none)."""
    n = o.shape[0]
    occ = torch.zeros(n, dtype=torch.bool, device=o.device)
    first_row = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    occluder = ~scene.is_light

    def visit(lo, hi, a, b, hit, t):
        mc = dist[lo:hi, None]
        if mode == "fast":
            blk = hit & (t < mc - T_MIN)
        else:
            sq = t * t
            blk = hit & (sq >= REF_EPS) & (sq < mc * mc)
        blk = blk & occluder[None, a:b]
        any_blk = blk.any(dim=1)
        if first:
            cand = torch.where(
                blk, torch.arange(a, b, device=o.device)[None], 2**62)
            fresh = any_blk & (first_row[lo:hi] < 0)
            first_row[lo:hi] = torch.where(fresh, cand.amin(dim=1),
                                           first_row[lo:hi])
        occ[lo:hi] |= any_blk

    _sweep(scene, o, d, mode, visit)
    return (occ, first_row) if first else occ


# ----------------------------------------------------------------------
# The estimators
# ----------------------------------------------------------------------

def take(table, idx):
    """Rows ``idx`` (any shape) of ``table``, whose gradient sums back by
    ``index_add_``: indexing's own backward sorts the rows and sums each
    run of one row in one warp, which crawls on tables of a few rows."""
    out = table.index_select(0, idx.reshape(-1))
    return out.reshape(*idx.shape, *table.shape[1:])


def onb(n):
    """Orthonormal tangents about unit n (Duff et al. 2017)."""
    sign = torch.where(n[:, 2] >= 0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[:, 2])
    b = n[:, 0] * n[:, 1] * a
    t = torch.stack([1.0 + sign * n[:, 0] * n[:, 0] * a, sign * b,
                     -sign * n[:, 0]], dim=1)
    bt = torch.stack([b, sign + n[:, 1] * n[:, 1] * a, -n[:, 1]], dim=1)
    return t, bt


def _where3(mask, a, b):
    return torch.where(mask[:, None], a, b)


def _resolve(sel, grad: bool, o, d, scene: Scene, mode: str, v):
    """(found, t, row) of the alive lanes ``sel``; with ``grad`` the
    winners' distances solved again from their triangles with autograd."""
    n = o.shape[0]
    found = torch.zeros(n, dtype=torch.bool, device=o.device)
    row = torch.zeros(n, dtype=torch.int64, device=o.device)
    t = torch.zeros(n, dtype=o.dtype, device=o.device)
    f, ts, r = nearest(scene, o[sel].detach(), d[sel].detach(), mode)
    found[sel], row[sel] = f, r
    if not grad:
        t[sel] = torch.where(f, ts, torch.zeros_like(ts))
        return found, t, row
    t_again = moller(o, d, *(take(x, row) for x in v))[1]
    return found, torch.where(found, t_again, torch.zeros_like(t_again)), row


def trace(scene: Scene, key, counters, o, d, n_bounces: int, n_light: int,
          mode: str = "fast", grad: bool = False):
    """Radiance [N, 3] of the paths ``counters`` from rays (o, d) [N, 3]
    under the base key, ``n_bounces`` bounces and ``n_light`` light samples
    a bounce. ``grad``: differentiable in the scene's float tensors (fast
    mode)."""
    dt = scene.dtype
    n = o.shape[0]
    alive = torch.ones(n, dtype=torch.bool, device=o.device)
    prev_spec = torch.ones_like(alive)
    thr = torch.ones(n, dtype=dt, device=o.device)
    rad = torch.zeros((n, 3), dtype=dt, device=o.device)
    verts = (scene.v0, scene.v1, scene.v2)
    if grad:
        cr = cross(scene.v1 - scene.v0, scene.v2 - scene.v0)
        normals = cr * torch.rsqrt(dot(cr, cr))[:, None]
        lcr = cross(scene.lv1 - scene.lv0, scene.lv2 - scene.lv0)
        light_area = torch.sqrt(dot(lcr, lcr)).detach() / 2.0
    else:
        normals, light_area = scene.normal, scene.light_area
    cum = torch.cumsum(light_area, dim=0)
    for b in range(n_bounces):
        u_nee = uniforms(derive(key, 4 * b), counters, 5 * n_light, dt)
        u_sc = uniforms(derive(key, 4 * b + 1), counters, 3, dt)
        d_in = unit(d)
        sel = alive.nonzero()[:, 0]
        found, t, row = _resolve(sel, grad, o, d_in, scene, mode, verts)
        point = o + d_in * t[:, None]
        normal = take(normals, row)
        mat = scene.material[row]
        is_light = scene.is_light[row] & found
        rgb = take(scene.rgb, mat)
        kd, ks = take(scene.kd, mat), take(scene.ks, mat)
        ambient3 = rgb * (take(scene.ka, mat) * scene.ambient)[:, None]
        relevant = alive & found & ~is_light
        rel = relevant.nonzero()[:, 0]
        u = u_nee[:, rel].reshape(n_light, 5, -1)
        p_rel = take(point, rel)
        x = u[:, 0] * cum[-1]
        pick = torch.zeros(x.shape, dtype=torch.int64, device=o.device)
        for c in cum[:-1]:
            pick = pick + (x >= c).to(torch.int64)
        if mode == "fast":
            sn = normal * torch.sign(-dot(normal, d_in) + 1e-12)[:, None]
            su = torch.sqrt(u[:, 1])
            bary = (1.0 - su, su * (1.0 - u[:, 2]), su * u[:, 2])
        else:
            sn = normal
            tot = u[:, 1] + u[:, 2] + u[:, 3]
            bary = (u[:, 1] / tot, u[:, 2] / tot, u[:, 3] / tot)
        lp = (bary[0][..., None] * take(scene.lv0, pick)
              + bary[1][..., None] * take(scene.lv1, pick)
              + bary[2][..., None] * take(scene.lv2, pick))     # [S, R, 3]
        vec = lp - p_rel[None]
        sq = dot(vec, vec)
        dist = torch.sqrt(sq + 1e-24)
        sdir = vec * torch.rsqrt(torch.clamp_min(sq, 1e-30))[..., None]
        cos = dot(sdir, take(sn, rel)[None])
        if mode == "fast":
            cos = torch.maximum(cos, torch.zeros_like(cos))
        flat = lambda x_: x_.reshape(-1, *x_.shape[2:])
        src = p_rel[None].expand(n_light, -1, 3)
        if mode == "fast":
            occ = blocked(scene, flat(src).detach(), flat(sdir).detach(),
                          flat(dist).detach(), mode)
        else:
            occ = blocked(scene, flat(src), flat(sdir), flat(dist), mode)
            _, first = blocked(scene, src[-1], sdir[-1], dist[-1], mode,
                               first=True)
        occ = occ.reshape(n_light, -1)
        mean_cos = torch.where(occ, torch.zeros_like(cos), cos).sum(0) / \
            float(n_light)
        if mode == "fast":
            direct_rgb = take(rgb, rel)
        else:
            quirk = torch.where(first >= 0, scene.material[first.clamp_min(0)],
                                scene.n_objects - 1)
            direct_rgb = take(scene.rgb, quirk)
        direct = torch.zeros_like(rad).index_put(
            (rel,), scene.light_color * direct_rgb * mean_cos[:, None])
        if mode == "fast":
            light3 = torch.where(prev_spec[:, None], scene.light_color,
                                 torch.zeros_like(rad))
        else:
            light3 = scene.light_color.expand_as(rad)
        color = _where3(found, _where3(is_light, light3, ambient3 + direct),
                        torch.zeros_like(rad))
        rad = rad + _where3(alive, color * thr[:, None], torch.zeros_like(rad))

        if mode == "fast":
            r = torch.sqrt(u_sc[1])
            th = TAU * u_sc[2]
            z = torch.sqrt(torch.clamp_min(1.0 - u_sc[1], 0.0))
            tt, bb = onb(sn)
            diffuse = unit((r * torch.cos(th))[:, None] * tt
                           + (r * torch.sin(th))[:, None] * bb
                           + z[:, None] * sn)
            spec = d_in - 2.0 * dot(d_in, sn)[:, None] * sn
            w = kd + ks
            p_diff = torch.where(w > 0, kd / torch.clamp_min(w, 1e-12),
                                 torch.ones_like(w))
            choose = u_sc[0] < p_diff
            factor = w
        else:
            diffuse = _upstream_rotate(_upstream_cosine(u_sc), normal)
            spec = _upstream_rotate(unit(2.0 * dot(normal, d)[:, None] * normal
                                         - d), normal)
            eye_vec = unit(scene.eye - point)
            choose = u_sc[0] * (kd + ks) <= kd
            factor = torch.where(
                choose, kd * dot(diffuse, normal),
                ks * _numpy_power(dot(eye_vec, spec), take(scene.phong, mat)))
        new_dir = _where3(choose, diffuse, spec)
        nxt = alive & found & ~is_light
        o = _where3(nxt, point, o)
        d = _where3(nxt, new_dir, d)
        thr = torch.where(nxt, thr * factor, thr)
        prev_spec = alive & ~choose
        alive = nxt
    return rad


def _upstream_cosine(u):
    phi = torch.arccos(torch.sqrt(u[1]))
    th = TAU_UPSTREAM * u[2]
    sp = torch.sin(phi)
    return torch.stack([sp * torch.cos(th), sp * torch.sin(th),
                        torch.cos(phi)], dim=1)


def _upstream_rotate(v, n):
    """The upstream tangent frame: a rotation about the fixed y axis by
    arccos(n_y), whose middle row passes v_y through."""
    ang = torch.arccos(torch.clamp(n[:, 1], -1.0, 1.0))
    a, c = torch.cos(ang / 2.0), -torch.sin(ang / 2.0)
    p, q = a * a - c * c, 2.0 * a * c
    return torch.stack([p * v[:, 0] - q * v[:, 2], v[:, 1],
                        q * v[:, 0] + p * v[:, 2]], dim=1)


def _numpy_power(base, e):
    """base ** e as numpy computes it for floats: a negative base keeps
    the sign parity of an integral exponent, and is NaN otherwise."""
    r = torch.round(e)
    mag = torch.pow(base.abs(), e)
    odd = torch.remainder(r, 2.0) == 1.0
    neg = torch.where(r == e, torch.where(odd, -mag, mag),
                      torch.full_like(mag, float("nan")))
    return torch.where(base >= 0, mag, neg)


# ----------------------------------------------------------------------
# Progressive renders and fits
# ----------------------------------------------------------------------

@torch.no_grad()
def render_pixels(scene: Scene, seed: int, pixels: torch.Tensor,
                  total_spp: int, chunk_spp: int, n_bounces: int,
                  n_light: int, mode: str = "fast",
                  lanes: int = 1 << 20) -> torch.Tensor:
    """The progressive image's radiance [P, 3] (float32) at ``pixels``:
    the mean of ceil(total / chunk) chunks of ``chunk_spp`` samples, chunk
    i under ``chunk_seed(seed, i)``; lanes in blocks of about ``lanes``."""
    n_chunks = -(-total_spp // chunk_spp)
    acc = torch.zeros((pixels.shape[0], 3), dtype=torch.float32,
                      device=pixels.device)
    step = max(1, lanes // chunk_spp)
    for c in range(n_chunks):
        key = key_of(chunk_seed(seed, c))
        for lo, hi in _tiles(pixels.shape[0], step):
            pix = pixels[lo:hi]
            o, d = primary_rays(scene, pix)
            s = torch.arange(chunk_spp, device=pix.device)
            ids = (pix[None, :] * chunk_spp + s[:, None]).reshape(-1)
            rad = trace(scene, key, ids, o.repeat(chunk_spp, 1),
                        d.repeat(chunk_spp, 1), n_bounces, n_light, mode)
            acc[lo:hi] += rad.float().reshape(chunk_spp, -1, 3).sum(0)
    return acc / float(n_chunks * chunk_spp)


PARAMS_FIT = ("mat_rgb", "mat_ka", "mat_kd", "light_color", "ambient",
              "tri_v0", "tri_v1", "tri_v2", "light_v0", "light_v1",
              "light_v2")


def scene_params(scene: Scene) -> dict:
    """The fit's leaves of the reference scene, detached copies."""
    return {
        "mat_rgb": scene.rgb, "mat_ka": scene.ka, "mat_kd": scene.kd,
        "light_color": scene.light_color, "ambient": scene.ambient,
        "tri_v0": scene.v0, "tri_v1": scene.v1, "tri_v2": scene.v2,
        "light_v0": scene.lv0, "light_v1": scene.lv1, "light_v2": scene.lv2,
    }


def with_params(scene: Scene, p: dict) -> Scene:
    """The scene under the params: the light's triangles move both its
    sampling table and its rows among the triangles."""
    rows = scene.light_rows
    v = [p[f"tri_v{k}"].index_copy(0, rows, p[f"light_v{k}"])
         for k in range(3)]
    return Scene(v0=v[0], v1=v[1], v2=v[2], normal=scene.normal,
                 material=scene.material, is_light=scene.is_light,
                 rgb=p["mat_rgb"], ka=p["mat_ka"], kd=p["mat_kd"],
                 ks=scene.ks, phong=scene.phong, lv0=p["light_v0"],
                 lv1=p["light_v1"], lv2=p["light_v2"],
                 light_area=scene.light_area, light_rows=rows,
                 light_color=p["light_color"], ambient=p["ambient"],
                 eye=scene.eye, ortho=scene.ortho, width=scene.width,
                 height=scene.height, n_objects=scene.n_objects)


def image_all(scene: Scene, key, spp: int, n_bounces: int, n_light: int,
              grad_fn=None, pixels_per_block: int = 1 << 16):
    """The radiance of every pixel [W*H, 3] under one key, ``spp`` samples
    as lanes. With ``grad_fn(block_pixels, radiance_block) -> loss part``,
    each block's part is differentiated at once (its graph then freed) and
    the summed loss is returned instead."""
    n_pix = scene.width * scene.height
    dev = scene.device
    out = None if grad_fn is not None else torch.zeros(
        (n_pix, 3), dtype=torch.float32, device=dev)
    total = 0.0
    for lo, hi in _tiles(n_pix, pixels_per_block):
        pix = torch.arange(lo, hi, device=dev)
        o, d = primary_rays(scene, pix)
        s = torch.arange(spp, device=dev)
        ids = (pix[None, :] * spp + s[:, None]).reshape(-1)
        with torch.set_grad_enabled(grad_fn is not None):
            rad = trace(scene, key, ids, o.repeat(spp, 1), d.repeat(spp, 1),
                        n_bounces, n_light, grad=grad_fn is not None)
            rad = rad.reshape(spp, -1, 3).sum(0) / float(spp)
            if grad_fn is None:
                out[lo:hi] = rad.float()
            else:
                part = grad_fn(pix, rad)
                part.backward(retain_graph=True)
                total += float(part.detach())
    return out if grad_fn is None else total


def fit_steps(scene: Scene, target: torch.Tensor, start: dict, keys: list,
              spp: int, n_bounces: int, n_light: int, lr: float):
    """The fit's first steps under the reference: for each key the loss
    0.5 * mean((image - target)^2) at the current params, its gradient,
    and an Adam step (b1 0.9, b2 0.999, eps 1e-8). Returns (losses, the
    first step's gradients, the params after the last step)."""
    p = {k: v.detach().clone() for k, v in start.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses, first = [], None
    denom = float(target.numel())
    for i, key in enumerate(keys):
        leaves = {k: x.clone().requires_grad_(True) for k, x in p.items()}
        sc = with_params(scene, leaves)

        def part(pix, rad):
            return 0.5 * ((rad.float() - target[pix]) ** 2).sum() / denom

        losses.append(image_all(sc, key, spp, n_bounces, n_light,
                                grad_fn=part))
        grads = {k: x.grad if x.grad is not None else torch.zeros_like(x)
                 for k, x in leaves.items()}
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
        step = i + 1
        with torch.no_grad():
            for k in p:
                g = grads[k]
                m[k] = b1 * m[k] + (1 - b1) * g
                v2[k] = b2 * v2[k] + (1 - b2) * g * g
                mh = m[k] / (1 - b1 ** step)
                vh = v2[k] / (1 - b2 ** step)
                p[k] = p[k] - lr * mh / (torch.sqrt(vh) + eps)
    return losses, first, p
