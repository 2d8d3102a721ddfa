"""Boundary-aware (soft) visibility: differentiable silhouettes and shadows,
the JAX package's ``diff/boundary.py`` on PyTorch.

The hard estimator's visibility is a step function of the geometry: the
nearest-hit winner and the binary shadow occlusion carry no gradient, so an
opaque object moving in its own plane has zero interior gradient. With
``RenderConfig.soft_vis_beta > 0`` the integrator uses this module instead:

- every triangle gets a *coverage* ``sigmoid(margin / beta)``, where
  ``margin`` is the signed world-space distance from the ray's plane-hit
  point to the nearest edge line (positive inside); at ``beta -> 0`` it is
  the hard indicator;
- **shadows**: occlusion = ``min(1, sum of coverages)`` over the occluder
  triangles inside the shadow window (a sum, so that two triangles sharing
  an edge cover it fully);
- **silhouettes**: the front-most *extended* hit F (margins down to
  ``-BAND_SIGMAS * beta``) is blended over the first true hit behind it,
  ``cov_F * shade(F) + (1 - cov_F) * shade(behind)``; the radiance is then
  continuous in the vertices, and central differences validate autograd.

No Pallas kernel lies on this path in the JAX package (its sweeps are plain
XLA), so the port is plain PyTorch on the card too. Gradients flow through
the whole sweep (no ``autograd.Function``). Each tile of the dense sweeps
and each ray block of the cluster sweeps runs under
``torch.utils.checkpoint`` when grad is on, as ``jax.checkpoint`` wraps
them there: the backward otherwise holds every tile's [N, tile] solve.

**The cluster sweeps** (scenes of ``SOFT_ACCEL_MIN_TRIS`` rows and more):
per block of ``SOFT_R_BLK`` rays, the triangles of the candidate clusters
(``kernels/sparse.py``'s clusters of ``SOFT_C_TRI`` rows and interval slab
test) are gathered and swept with the same math. Selection is detached;
the gathered vertices stay differentiable. Where a block has more than
``SOFT_KMAX`` candidates the whole sweep falls back to the dense one (a
host branch, counted in ``FALLBACKS``). Shadow coverage terms outside every
candidate have margin <= -band, so each is below sigmoid(-6) ~ 2.5e-3;
the silhouette records are exact.

Two departures from the JAX package, both faults of its cluster sweeps:

1. A cluster's candidate box holds every point whose margin exceeds -band:
   the box over each triangle's band-offset triangle (each edge line moved
   out by band, which moves vertex i out by band / sin(alpha_i / 2)). The
   JAX package grows the vertex box by band alone, which misses near-misses
   by a vertex, so its sparse front record can differ from the dense one.
2. A ragged last ray block is padded by repeating its last lane; the JAX
   package pads with origin 1e6, which widens that block's box over the
   scene and can overflow ``SOFT_KMAX`` into the dense fallback.

Also: a tile of the dense sweeps is the scene's rows [start, start + TILE),
the last one ragged where ``TILE`` does not divide the row count (the JAX
sweep's ``dynamic_slice`` would shift it back instead). Scenes packed with
the default ``pad_to=128`` never have a ragged tile.

Under a geometry ring the integrator runs these dense tiles on every shard
(``parallel/ring.py:soft_hits_ring``, ``soft_visibility_ring``), the tile
carry passed from shard to shard with global rows, where the JAX package
sweeps the rank's own shard only; the cluster sweeps do not run there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from pathtracerpython_tpu_torch.kernels.sparse import (
    candidate_enter_hit,
    cluster_aabbs,
    pack_for_sparse,
    pad_repeat_last,
)
from pathtracerpython_tpu_torch.ops.gather import take_rows
from pathtracerpython_tpu_torch.ops.geometry import safe_normalize
from pathtracerpython_tpu_torch.utils.metrics import span

BAND_SIGMAS = 6.0   # extended-hit acceptance: margin > -BAND_SIGMAS * beta
T_MIN = 1e-4
BIG = 3.0e38
IMAX = 2**31 - 1
# A near-miss (margin < 0) must lead the nearest true hit by this relative
# t-margin to become F: coplanar contact (a box's bottom face in the floor's
# plane) would otherwise make F a coin flip at ulp-equal t.
F_TIE_EPS = 1e-4
TILE = 128  # the JAX package's RenderConfig.tile: the dense sweeps' width

SOFT_ACCEL_MIN_TRIS = 4096  # below this the dense O(N*T) sweep is cheap
SOFT_C_TRI = 32             # cluster granularity for the soft gathers
SOFT_KMAX = 192             # candidate clusters per ray block
SOFT_R_BLK = 256            # rays per block
# Absolute slack added to the band-offset boxes, beyond the float rounding
# of a margin (scene coordinates are O(10), margins good to ~1e-5).
BOX_SLACK = 1e-4

# Cluster sweeps that fell back to the dense sweep since the count was last
# reset (a block had more than SOFT_KMAX candidates).
FALLBACKS = 0


def _f_key(t, margin):
    """Extended-front ordering key: true hits order by t; near-misses pay
    the coplanar-tie bias."""
    return torch.where(margin < 0.0, t + F_TIE_EPS * (1.0 + t.abs()), t)


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def plane_hit_and_margin(origin, d_unit, v0, v1, v2, eps: float = 1e-7):
    """Möller–Trumbore plane solve and signed edge margin of broadcastable
    row-major [..., 3] rays and triangles. Returns (ok, t, margin): ``ok``
    only excludes near-parallel rays; ``margin`` is the world-space signed
    distance from the ray-plane intersection to the nearest edge line
    (positive strictly inside). Smooth in the vertices wherever the ray is
    not parallel to the plane."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = _cross(d_unit, e2)
    det = _dot(e1, pvec)
    ok = det.abs() > eps
    inv_det = 1.0 / torch.where(ok, det, 1.0)
    tvec = origin - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d_unit, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det

    # barycentrics (1-u-v, u, v) belong to (v0, v1, v2); the distance from
    # a point of the plane to the edge line opposite vertex i is
    # lambda_i * h_i with h_i = 2 * area / |edge_i|
    cross = _cross(e1, e2)
    two_area = torch.sqrt(_dot(cross, cross) + 1e-30)

    def h(edge):
        return two_area / torch.sqrt(_dot(edge, edge) + 1e-30)

    m0 = (1.0 - u - v) * h(v2 - v1)
    m1 = u * h(v0 - v2)
    m2 = v * h(v1 - v0)
    margin = torch.minimum(torch.minimum(m0, m1), m2)
    return ok, t, margin


class SoftHits(NamedTuple):
    """Per-ray records for the silhouette blend ([N] each)."""

    f_t: torch.Tensor       # front extended hit (margin > -band)
    f_idx: torch.Tensor     # i32, IMAX where none
    f_margin: torch.Tensor  # differentiable signed edge distance of F
    h1_t: torch.Tensor      # first true hit
    h1_idx: torch.Tensor
    h2_t: torch.Tensor      # second true hit (another triangle)
    h2_idx: torch.Tensor


def _grad_on(scene, *tensors) -> bool:
    """Whether grad mode is on and the rays or the scene's vertices require
    grad: then each tile or block runs under ``torch.utils.checkpoint``."""
    return torch.is_grad_enabled() and any(
        x.requires_grad for x in (*tensors, scene.tri_v0, scene.tri_v1,
                                  scene.tri_v2))


def _run(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat`` under ``torch.utils.checkpoint``, so
    that the backward recomputes ``fn``'s intermediates instead of holding
    them."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# --- the dense sweeps -----------------------------------------------------

def _tiles(n_rows: int):
    """(start, stop) of every tile of ``TILE`` rows; the last may be
    ragged."""
    return [(s, min(s + TILE, n_rows)) for s in range(0, n_rows, TILE)]


def _take_at(x, col):
    return x.gather(1, col[:, None])[:, 0]


def _dense_tile(carry, origin, d_unit, v0, v1, v2, valid, start: int,
                band: float):
    """One tile of ``soft_hits_sweep_dense``: the tile's two smallest true
    hits merged into (h1, h2), its extended front merged into F."""
    fk, ft, fidx, fm, h1t, h1idx, h2t, h2idx = carry
    ok, t, margin = plane_hit_and_margin(origin[:, None, :],
                                         d_unit[:, None, :], v0[None],
                                         v1[None], v2[None])
    base = ok & valid[None, :] & (t > T_MIN)
    cols = torch.arange(t.shape[1], device=t.device)

    def tile_index(col, key):
        return torch.where(key < BIG, (col + start).to(torch.int32), IMAX)

    # true hits: the tile's two smallest t (first index on ties)
    key = torch.where(base & (margin >= 0.0), t, BIG)
    a1 = key.argmin(dim=1)
    k1 = _take_at(key, a1)
    # out of place: autograd saved ``key``
    key2 = torch.where(cols[None, :] == a1[:, None], BIG, key)
    a2 = key2.argmin(dim=1)
    k2 = _take_at(key2, a2)
    i1, i2 = tile_index(a1, k1), tile_index(a2, k2)
    # merge ordered pairs: the winner, then the smaller of the losers
    first_is_old = (h1t < k1) | ((h1t == k1) & (h1idx < i1))
    n1t = torch.where(first_is_old, h1t, k1)
    n1i = torch.where(first_is_old, h1idx, i1)
    lt = torch.where(first_is_old, k1, h1t)
    li = torch.where(first_is_old, i1, h1idx)
    second_is_l = (lt < h2t) | ((lt == h2t) & (li < h2idx))
    s2t = torch.where(second_is_l, lt, h2t)
    s2i = torch.where(second_is_l, li, h2idx)
    better2 = (k2 < s2t) | ((k2 == s2t) & (i2 < s2i))
    n2t = torch.where(better2, k2, s2t)
    n2i = torch.where(better2, i2, s2i)

    # extended front: the smallest biased key among margin > -band
    keyf = torch.where(base & (margin > -band), _f_key(t, margin), BIG)
    af = keyf.argmin(dim=1)
    kf = _take_at(keyf, af)
    idf = tile_index(af, kf)
    better = (kf < fk) | ((kf == fk) & (idf < fidx))
    nfk = torch.where(better, kf, fk)
    nft = torch.where(better, _take_at(t, af), ft)
    nfidx = torch.where(better, idf, fidx)
    nfm = torch.where(better, _take_at(margin, af), fm)
    nft = torch.where(nfidx != IMAX, nft, BIG)
    return nfk, nft, nfidx, nfm, n1t, n1i, n2t, n2i


def soft_hits_sweep_dense(origin, direction, scene, beta: float) -> SoftHits:
    """One pass over the triangle buffer collecting F, hit1 and hit2 of rays
    ``origin``, ``direction`` [N, 3] (the direction need not be unit).

    True hits use the hard acceptance (margin >= 0); F also accepts
    near-misses down to ``-BAND_SIGMAS * beta``. Winners follow the dense
    sweeps' lexicographic (t, index) rule."""
    n = origin.shape[0]
    n_rows = scene.tri_v0.shape[0]
    d_unit = safe_normalize(direction)
    band = BAND_SIGMAS * float(beta)
    big = origin.new_full((n,), BIG)
    imax = torch.full((n,), IMAX, dtype=torch.int32, device=origin.device)
    carry = (big, big, imax, origin.new_zeros((n,)), big, imax, big, imax)
    remat = _grad_on(scene, origin, direction)
    for lo, hi in _tiles(n_rows):
        carry = _run(remat, _dense_tile, carry, origin, d_unit,
                     scene.tri_v0[lo:hi], scene.tri_v1[lo:hi],
                     scene.tri_v2[lo:hi], scene.tri_valid[lo:hi], lo, band)
    return SoftHits(*carry[1:])


def _cov_tile(cov_sum, origin, d_unit, max_dist, v0, v1, v2, occluder,
              beta: float):
    ok, t, margin = plane_hit_and_margin(origin[:, None, :],
                                         d_unit[:, None, :], v0[None],
                                         v1[None], v2[None])
    window = ok & occluder[None, :] & (t > T_MIN) & (
        t < max_dist[:, None] - T_MIN)
    cov = torch.where(window, torch.sigmoid(margin / beta), 0.0)
    return cov_sum + cov.sum(dim=1)


def _soft_visibility_cov(origin, direction, max_dist, scene,
                         beta: float) -> torch.Tensor:
    """Dense O(N*T) shadow-coverage sum (before the clamp)."""
    n_rows = scene.tri_v0.shape[0]
    d_unit = safe_normalize(direction)
    cov = origin.new_zeros((origin.shape[0],))
    remat = _grad_on(scene, origin, direction, max_dist)
    for lo, hi in _tiles(n_rows):
        cov = _run(remat, _cov_tile, cov, origin, d_unit, max_dist,
                   scene.tri_v0[lo:hi], scene.tri_v1[lo:hi],
                   scene.tri_v2[lo:hi], scene.tri_occluder[lo:hi], beta)
    return cov


def _visibility(cov: torch.Tensor) -> torch.Tensor:
    """1 - min(cov, 1). ``torch.minimum``, not ``clamp_max``: a sum of
    saturated coverages is often exactly 1, where ``jnp.minimum`` (and
    ``torch.minimum``) split the gradient in half and ``clamp_max`` passes
    all of it."""
    return 1.0 - torch.minimum(cov, torch.ones_like(cov))


# --- the cluster sweeps ---------------------------------------------------

def band_offset_pack(tripack: torch.Tensor, band: float) -> torch.Tensor:
    """The [T, 12] pack with each triangle replaced by its band-offset
    triangle: every edge line moved out by ``band`` in the triangle's
    plane, so vertex i moves out along its bisector by
    band / sin(alpha_i / 2), i.e. by band * (u1 + u2) / sin(alpha_i) for the
    unit edge vectors u1, u2 leaving it. The offset triangle is the set of
    plane points whose margin exceeds -band, so its box holds every
    (near-)hit the soft sweeps accept. A degenerate triangle's region is
    unbounded: its offset vertices span +-BIG. Rows not valid keep their
    vertices (``cluster_aabbs`` masks them)."""
    v = tripack[:, 0:9].reshape(-1, 3, 3)          # [T, vertex, xyz]
    u1 = safe_normalize(v.roll(-1, dims=1) - v)    # to the next vertex
    u2 = safe_normalize(v.roll(1, dims=1) - v)     # to the previous one
    sin_a = torch.linalg.vector_norm(_cross(u1, u2), dim=-1)
    grow = band * (1.0 + 1e-3) + BOX_SLACK
    off = v - grow * (u1 + u2) / sin_a[..., None]
    bounded = (torch.isfinite(off).all(dim=2).all(dim=1)
               & (sin_a > 0).all(dim=1))
    span = v.new_tensor([[-BIG] * 3, [BIG] * 3, [BIG] * 3])
    off = torch.where(bounded[:, None, None], off, span)
    valid = tripack[:, 9:10] > 0.5
    verts = torch.where(valid, off.reshape(-1, 9), tripack[:, 0:9])
    return torch.cat([verts, tripack[:, 9:]], dim=1)


class Candidates(NamedTuple):
    """Per ray block, the candidate clusters front to back by their
    conservative entry bound."""

    ids: torch.Tensor    # i32[nrb, k]
    valid: torch.Tensor  # bool[nrb, k]
    overflow: bool       # some block had more than ``SOFT_KMAX``


def soft_block_candidates(o3, d3, tmax_rb, scene,
                          band: float) -> Candidates:
    """The candidate clusters of every block of ``SOFT_R_BLK`` rays (o3, d3)
    [3, N] (a ragged last block padded by repeating its last lane) whose
    band-offset box (``band_offset_pack``) the block's interval slab test
    meets within ``tmax_rb`` [nrb]. Detached. Reads the largest candidate
    count on the host: the lists are cut to it (no block loses one) and it
    decides the overflow."""
    with torch.no_grad():
        grown = band_offset_pack(pack_for_sparse(scene.detach()), band)
        aabb8 = cluster_aabbs(grown, SOFT_C_TRI)
        enter, hit = candidate_enter_hit(aabb8, o3.detach(), d3.detach(),
                                         tmax_rb, SOFT_R_BLK)
        key = torch.where(hit, torch.clamp_min(enter, 0.0), BIG)
        with span("ptt.host_read"):
            n_max = int(hit.sum(dim=1).max())
        k = max(1, min(n_max, SOFT_KMAX, aabb8.shape[0]))
        vals, ids = torch.topk(-key, k, dim=1)
    return Candidates(ids.to(torch.int32), vals > -BIG,
                      n_max > min(SOFT_KMAX, aabb8.shape[0]))


def _gather_soft_tris(scene, cids, cvalid):
    """Differentiable gather of the candidate clusters' triangles:
    (v0, v1, v2 [M, 3], occluder bool[M], tri_ok bool[M], gidx i32[M]) with
    M = k * SOFT_C_TRI; invalid slots are masked by tri_ok. Out-of-range
    slots all read row 0, so the vertices' gradients are summed into the
    table by ``take_rows``' ``scatter_rows``."""
    tidx = (cids[:, None].to(torch.int64) * SOFT_C_TRI + torch.arange(
        SOFT_C_TRI, device=cids.device)[None, :]).reshape(-1)
    in_range = tidx < scene.tri_v0.shape[0]
    safe = torch.where(in_range, tidx, 0)
    slot_ok = cvalid.repeat_interleave(SOFT_C_TRI)
    tri_ok = slot_ok & in_range & scene.tri_valid[safe]
    occl = scene.tri_occluder[safe] & tri_ok
    return (take_rows(scene.tri_v0, safe), take_rows(scene.tri_v1, safe),
            take_rows(scene.tri_v2, safe), occl, tri_ok, safe.to(torch.int32))


def _lex_min(t, margin, gidx, accept, biased: bool):
    """(t, idx, margin) of the lexicographic (key, global index) minimum
    over accepted entries; ``biased`` orders by the coplanar-tie key while
    still reporting the true t. ``amax`` over the one-hot selection splits
    a tie's gradient as the JAX package's max does."""
    key = torch.where(accept, _f_key(t, margin) if biased else t, BIG)
    k = key.amin(dim=1, keepdim=True)
    at_k = (key == k) & accept
    idx = torch.where(at_k, gidx, IMAX).amin(dim=1)
    sel = at_k & (gidx == idx[:, None])
    m = torch.where(sel, margin, -BIG).amax(dim=1)
    tt = torch.where(sel, t, -BIG).amax(dim=1)
    return torch.where(idx != IMAX, tt, BIG), idx, m


def _hits_block(o_b, d_b, ids_b, val_b, scene, band: float):
    """F, hit1 and hit2 of one ray block against its candidates' rows."""
    v0, v1, v2, _, tri_ok, gidx = _gather_soft_tris(scene, ids_b, val_b)
    ok, t, margin = plane_hit_and_margin(o_b.T[:, None, :], d_b.T[:, None, :],
                                         v0[None], v1[None], v2[None])
    base = ok & tri_ok[None, :] & (t > T_MIN)
    gidx = gidx[None, :]
    true_hit = base & (margin >= 0.0)
    h1t, h1i, _ = _lex_min(t, margin, gidx, true_hit, False)
    second = true_hit & ~((torch.where(true_hit, t, BIG) == h1t[:, None])
                          & (gidx == h1i[:, None]))
    h2t, h2i, _ = _lex_min(t, margin, gidx, second, False)
    ft, fi, fm = _lex_min(t, margin, gidx, base & (margin > -band), True)
    fm = torch.where(fi != IMAX, fm, 0.0)
    return ft, fi, fm, h1t, h1i, h2t, h2i


def _blocks(x):
    """[3, N] (or [N]) padded by repeating the last lane, split into blocks
    of ``SOFT_R_BLK`` lanes."""
    return pad_repeat_last(x, SOFT_R_BLK).split(SOFT_R_BLK, dim=-1)


def soft_hits_sweep_sparse(origin, direction, scene,
                           beta: float) -> SoftHits:
    """``soft_hits_sweep_dense``'s records from each ray block's candidate
    triangles only: the dense records on every lane (a true or banded hit
    lies inside a candidate's band-offset box), ties resolved by the same
    (t, global index) rule. Overflow falls back to the dense sweep."""
    global FALLBACKS
    n = origin.shape[0]
    d_unit = safe_normalize(direction)
    band = BAND_SIGMAS * float(beta)
    o3, d3 = origin.T, d_unit.T
    tmax_rb = origin.new_full((-(-n // SOFT_R_BLK),), BIG)
    cand = soft_block_candidates(o3, d3, tmax_rb, scene, band)
    if cand.overflow:
        FALLBACKS += 1
        return soft_hits_sweep_dense(origin, direction, scene, beta)
    remat = _grad_on(scene, origin, direction)
    outs = [_run(remat, _hits_block, o_b, d_b, cand.ids[b], cand.valid[b],
                 scene, band)
            for b, (o_b, d_b) in enumerate(zip(_blocks(o3), _blocks(d3)))]
    return SoftHits(*(torch.cat(x)[:n] for x in zip(*outs)))


def _cov_block(o_b, d_b, md_b, ids_b, val_b, scene, beta: float):
    v0, v1, v2, occl, _, _ = _gather_soft_tris(scene, ids_b, val_b)
    ok, t, margin = plane_hit_and_margin(o_b.T[:, None, :], d_b.T[:, None, :],
                                         v0[None], v1[None], v2[None])
    window = ok & occl[None, :] & (t > T_MIN) & (t < md_b[:, None] - T_MIN)
    return torch.where(window, torch.sigmoid(margin / beta), 0.0).sum(dim=1)


def soft_visibility_sparse(origin, direction, max_dist, scene,
                           beta: float) -> torch.Tensor:
    """Cluster-accelerated ``soft_visibility``: O(N * K * SOFT_C_TRI) pairs.
    Overflow falls back to the dense sum."""
    global FALLBACKS
    n = origin.shape[0]
    d_unit = safe_normalize(direction)
    band = BAND_SIGMAS * float(beta)
    o3, d3 = origin.T, d_unit.T
    md = pad_repeat_last(max_dist, SOFT_R_BLK)
    tmax_rb = md.detach().reshape(-1, SOFT_R_BLK).amax(dim=1)
    cand = soft_block_candidates(o3, d3, tmax_rb, scene, band)
    if cand.overflow:
        FALLBACKS += 1
        cov = _soft_visibility_cov(origin, direction, max_dist, scene, beta)
    else:
        remat = _grad_on(scene, origin, direction, max_dist)
        cov = torch.cat([
            _run(remat, _cov_block, o_b, d_b, md_b, cand.ids[b], cand.valid[b],
                 scene, beta)
            for b, (o_b, d_b, md_b) in enumerate(zip(
                _blocks(o3), _blocks(d3), md.split(SOFT_R_BLK)))])[:n]
    return _visibility(cov)


# --- the entry points -----------------------------------------------------

def soft_hits_sweep(origin, direction, scene, beta: float) -> SoftHits:
    """F, hit1 and hit2 records of rays [N, 3]; scenes of
    ``SOFT_ACCEL_MIN_TRIS`` rows and more take the cluster sweep."""
    if scene.tri_v0.shape[0] >= SOFT_ACCEL_MIN_TRIS:
        return soft_hits_sweep_sparse(origin, direction, scene, beta)
    return soft_hits_sweep_dense(origin, direction, scene, beta)


def soft_visibility(origin, direction, max_dist, scene,
                    beta: float) -> torch.Tensor:
    """Smooth shadow visibility in [0, 1] of rays [N, 3] within
    ``max_dist`` [N]: ``1 - min(1, sum of coverages)`` over the occluder
    triangles strictly inside the shadow window. Differentiable in the
    occluders' vertices through the edge margins. Scenes of
    ``SOFT_ACCEL_MIN_TRIS`` rows and more take the cluster sweep."""
    if scene.tri_v0.shape[0] >= SOFT_ACCEL_MIN_TRIS:
        return soft_visibility_sparse(origin, direction, max_dist, scene,
                                      beta)
    return _visibility(_soft_visibility_cov(origin, direction, max_dist,
                                            scene, beta))
