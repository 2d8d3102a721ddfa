"""The wavefront path-tracing integrator (component-major layout).

The forward path of the JAX package's ``render/integrator.py``, in both
estimators:

    for each sample:                  (a Python loop, or extra lanes)
        state = primary rays          (ops.camera)
        for each bounce:              (a Python loop)
            [sort + park]             (ops.sort, cluster hierarchies)
            hit   = nearest_hit_cm    (K1 dense; K5 sparse and hybrid; K8
                                       walker; K3's Plücker form of K1
                                       and K5 under mt_impl="plucker")
            color = shade(hit)        (ambient + NEE: fused K2, or the
                                       unfused NEE with K4 dense, K6
                                       sparse, K7 sparse with the occluder
                                       cache, K9 walker and hybrid; K3's
                                       Plücker form of K4 and K6)
            state = scatter(hit)      (diffuse/specular branch, masked)

Every per-ray vector is float32 [3, N]; dead rays are masked lanes. The
RNG is the counter-based Threefry keyed by the global path id
``pixel_id * n_samples + sample``, bit-equal to the JAX package's, so both
plans (per-sample loop and ``batch_samples``) draw the same numbers and
give the same radiance. Sorting permutes lanes with their counters, so a
sorted render equals an unsorted one. The render runs on the device the
scene lives on.

The render is differentiable in the scene's tensors and the primary rays
with the hard estimator of the JAX package: the nearest sweeps and the
fused NEE carry their custom gradients (``kernels/intersect.py``
``NearestTIdx``, ``kernels/nee.py`` ``NeeMeanCos``), the discrete choices
(winners, occlusion, light pick, BRDF branch, sort order) carry none, and
no tensor autograd saved is written in place.

With ``soft_vis_beta > 0`` the soft estimator of ``diff/boundary.py``
replaces the nearest sweep (``_soft_hit_and_shade``: the front record
blended over the hit behind it) and the NEE's occlusion (smooth shadow
coverage), so that silhouettes and shadow edges carry gradients; it is
plain PyTorch, as the JAX package's is plain XLA, and launches none of
the kernels. The fused NEE and the shadow-lane sort are off there, as in
the JAX package; wavefront sorting and parking stay as ``accel`` sets them.
The sample loop is a Python loop in both estimators: the JAX package
unrolls soft samples only to dodge an XLA:TPU miscompile of its scan.

``remat_bounces`` runs each bounce under ``torch.utils.checkpoint`` when
grad is on (``jax.checkpoint`` there): the backward recomputes a bounce,
its kernel launches included, instead of holding its intermediates. The
RNG is counter-based, so the recompute draws the same numbers.

``mode="reference"`` is the reference program's estimator, quirks and
all, as the JAX package's reference branches write it: the row-major
reference sweeps of ``ops/geometry.py`` (plain PyTorch: the JAX package
runs them on XLA, never through a Pallas kernel), normalized-uniform
barycentrics and the unclamped cosine in the NEE, the colour of the last
light sample's first occluder (``shade_nee_reference``), light hits that
always pay, and ``scatter_reference``'s fixed-y-axis frames, raw-direction
specular and Phong factor toward the eye, all on the raw winding normal.
Reference mode is never sorted.

Under a geometry ring (``cfg.geom_axis``, set by
``parallel.shard.render_rays_sharded``) the nearest sweeps and the
any-hits run on triangle shards streamed around the ring
(``parallel/ring.py``); the gates turn sorting, the NEE sort, the
occluder cache and the fused NEE off there, as in the JAX package. The
soft sweeps stream around the ring too (``ring.soft_hits_ring``, whose
records bring their triangles' normal, material and light flag with them,
and ``ring.soft_visibility_ring``), where the JAX package sweeps the
rank's own shard only. A checkpointed bounce under a ring carries its
mesh (``parallel.mesh.carrying``), so that its recompute inside the
backward finds the ring.

Sorting only orders lanes: each lane carries its place in the wavefront
as it was made (``RayState.lane``), and ``_unscramble`` puts the radiance
back there, so ``render_rays`` returns its rays' radiance in the input
order for any pixel ids (a permutation, one shard's range of a sharded
render, padding that repeats an id).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from pathtracerpython_tpu_torch.kernels.nee import (
    FUSED_NEE_MAX_LIGHT_TRIS,
    MAX_LIGHT_SAMPLES,
    nee_mean_cos_fused,
)
from pathtracerpython_tpu_torch.kernels.sparse import (
    resolve_accel,
    sparse_any_hit_cached_cm,
    use_sparse,
)
from pathtracerpython_tpu_torch.ops import rng
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.ops.gather import cm_take
from pathtracerpython_tpu_torch.ops.geometry import (
    NearestHitCM,
    any_hit_within_cm,
    first_occluder_index,
    nearest_hit_cm,
    normalize3,
)
from pathtracerpython_tpu_torch.ops.sampling import (
    cm_cosine_hemisphere_fixed,
    cm_cosine_hemisphere_reference,
    cm_dot,
    cm_point_from_barycentric,
    cm_reflect,
    cm_rotate_frame_reference,
    cm_sample_barycentric_reference,
    cm_sample_barycentric_uniform,
    pick_light_triangle,
)
from pathtracerpython_tpu_torch.ops.sort import (
    PARK_DIR,
    PARK_ORIGIN,
    permute_minor,
    scene_bounds,
    unpermute_minor,
    wavefront_sort_order,
)
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.scene.arrays import SceneTensors
from pathtracerpython_tpu_torch.utils.metrics import count, span

# purpose salts for per-bounce key derivation
_P_NEE = 0
_P_SCATTER = 1


class RayState(NamedTuple):
    """Per-ray wavefront state; vectors are component-major [3, N]."""

    origin3: torch.Tensor      # f32[3, N]
    direction3: torch.Tensor   # f32[3, N] raw dir (primaries unnormalized)
    throughput: torch.Tensor   # f32[N]
    alive: torch.Tensor        # bool[N]
    radiance3: torch.Tensor    # f32[3, N] accumulated pixel color
    counters: torch.Tensor     # i64[N] global path id = pixel_id * spp + sample
    prev_specular: torch.Tensor  # bool[N] (fast-mode emission rule)
    nee_occ_hint: torch.Tensor   # bool[N] every shadow sample of the lane
    #                              was occluded last bounce: an ordering
    #                              signal of the sorted NEE sweep only
    nee_cache: torch.Tensor      # i32[N] the cluster that last blocked one
    #                              of the lane's shadow rays, -1 = none:
    #                              K7's guess (nee_cache="on" only)
    lane: torch.Tensor           # i64[N] the lane's place in the wavefront
    #                              as init_rays made it; sorts permute it


class Materials(NamedTuple):
    """Per-ray material properties (resolved once per bounce)."""

    rgb3: torch.Tensor  # f32[3, N]
    ka: torch.Tensor    # f32[N]
    kd: torch.Tensor    # f32[N]
    ks: torch.Tensor    # f32[N]
    n: torch.Tensor     # f32[N]


def _soft(cfg: RenderConfig) -> bool:
    """Whether the soft estimator runs (``diff/boundary.py``)."""
    return cfg.soft_vis_beta > 0.0 and cfg.mode == "fast"


def _sort_enabled(scene: SceneTensors, cfg: RenderConfig) -> bool:
    """Per-bounce wavefront sorting: on for the cluster hierarchies (block
    coherence is their performance model), or when asked for; never in
    reference mode (the parity gate) or under a geometry ring."""
    if cfg.mode != "fast" or cfg.geom_axis is not None:
        return False
    if cfg.sort_rays == "on":
        return True
    return cfg.sort_rays == "auto" and use_sparse(
        cfg.accel, scene.num_padded_triangles)


def _nee_sort_enabled(scene: SceneTensors, cfg: RenderConfig) -> bool:
    """Shadow-lane sorting (and with it relevance parking) runs where a
    cluster hierarchy's hard-shadow any-hit does: fast mode, no geometry
    ring, no soft visibility."""
    if cfg.sort_nee == "off" or cfg.mode != "fast":
        return False
    if cfg.geom_axis is not None or cfg.soft_vis_beta > 0.0:
        return False
    return use_sparse(cfg.accel, scene.num_padded_triangles)


def _nee_cache_enabled(scene: SceneTensors, cfg: RenderConfig) -> bool:
    """The occluder cache runs on the sparse hierarchy's hard-shadow
    any-hit only, and only when asked for: "auto" is off."""
    return (cfg.nee_cache == "on" and cfg.mode == "fast"
            and cfg.geom_axis is None and cfg.soft_vis_beta == 0.0
            and resolve_accel(cfg.accel, scene.num_padded_triangles)
            == "sparse")


def _fused_nee(scene: SceneTensors, cfg: RenderConfig) -> bool:
    """The fused K2 runs in fast mode with hard shadows and no geometry
    ring, on dense scenes whose light and sample count fit it; everything
    else takes the unfused NEE."""
    return (cfg.mode == "fast" and cfg.geom_axis is None
            and cfg.soft_vis_beta == 0.0
            and resolve_accel(cfg.accel, scene.num_padded_triangles) == "none"
            and scene.light_area.shape[0] <= FUSED_NEE_MAX_LIGHT_TRIS
            and cfg.n_light_samples <= MAX_LIGHT_SAMPLES)


def resolve_materials(scene: SceneTensors, material) -> Materials:
    rgb3 = cm_take(scene.mat_rgb.T, material)
    scalars = cm_take(
        torch.stack([scene.mat_ka, scene.mat_kd, scene.mat_ks, scene.mat_n]),
        material,
    )
    return Materials(
        rgb3=rgb3, ka=scalars[0], kd=scalars[1], ks=scalars[2], n=scalars[3],
    )


def _power_numpy_semantics(base: torch.Tensor,
                           exponent: torch.Tensor) -> torch.Tensor:
    """base ** exponent with numpy's float semantics (JAX
    ``render/integrator.py:117``): a negative base keeps its sign parity
    under an integral exponent and is NaN under a fractional one. The
    reference raises a Phong cosine that may be negative to a float
    power."""
    r = torch.round(exponent)
    is_int = r == exponent
    odd = torch.remainder(r, 2.0) == 1.0
    mag = torch.pow(torch.abs(base), exponent)
    neg_case = torch.where(is_int, torch.where(odd, -mag, mag),
                           torch.nan)
    return torch.where(base >= 0.0, mag, neg_case)


class ShadowRays(NamedTuple):
    """The unfused NEE's S*N shadow rays in the order they are swept."""

    o3: torch.Tensor     # f32[3, S*N]
    d3: torch.Tensor     # f32[3, S*N] unit length
    maxd: torch.Tensor   # f32[S*N] distance to the light point; 0 = parked
    order: torch.Tensor | None  # i64[S*N] lane s*N + i of sweep slot k,
    #                             None when unsorted
    cos: torch.Tensor    # f32[S, N] clamped cosine of each sample
    relevant: torch.Tensor  # bool[S*N] the radiance reads the lane's bit


def nee_shadow_rays(hit: NearestHitCM, u, scene: SceneTensors,
                    cfg: RenderConfig, shading_normal3, relevant,
                    occ_hint) -> ShadowRays:
    """The unfused NEE's light samples (area-CDF light pick, sqrt-trick
    barycentrics) as shadow rays from the hit points. Where the shadow-lane
    sort runs, the rays whose result the radiance discards (not
    ``relevant`` bool[N]) are parked, and the lanes are sorted by their own
    key, with predicted-occluded lanes (``occ_hint`` bool[N]) first when
    ``cfg.nee_hint == "on"``."""
    s = cfg.n_light_samples
    point3 = hit.point3
    n = point3.shape[1]
    u = u.reshape(s, 5, n)
    tri = pick_light_triangle(u[:, 0], scene.light_area)          # [S, N]
    bary = cm_sample_barycentric_uniform(u[:, 1:3].transpose(0, 1))
    lv = cm_take(torch.cat([scene.light_v0.T, scene.light_v1.T,
                            scene.light_v2.T]), tri)              # [9, S, N]
    light_pt3 = cm_point_from_barycentric(bary, lv[0:3], lv[3:6], lv[6:9])
    vec3 = light_pt3 - point3[:, None, :]
    # sqrt(x + tiny) for the distance, rsqrt(max(x, tiny)) for the direction
    dist = torch.sqrt(cm_dot(vec3, vec3) + 1e-24)                 # [S, N]
    sdir3 = normalize3(vec3)
    cos = torch.clamp_min(cm_dot(sdir3, shading_normal3[:, None, :]), 0.0)

    flat_o3 = point3[:, None, :].expand(3, s, n).reshape(3, s * n)
    flat_d3 = sdir3.reshape(3, s * n)
    flat_dist = dist.reshape(s * n)
    rel_flat = relevant[None, :].expand(s, n).reshape(s * n)
    if not _nee_sort_enabled(scene, cfg):
        return ShadowRays(flat_o3, flat_d3, flat_dist, None, cos, rel_flat)
    # park the irrelevant lanes only where the sort groups them into blocks
    # of their own: a parked origin in a mixed block widens the block's box
    # over the whole scene (the JAX package measured 31 s against 1.1 s per
    # render when parking without sorting)
    flat_o3 = torch.where(rel_flat[None, :], flat_o3,
                          flat_o3.new_tensor(PARK_ORIGIN)[:, None])
    flat_d3 = torch.where(rel_flat[None, :], flat_d3,
                          flat_d3.new_tensor(PARK_DIR)[:, None])
    flat_dist = torch.where(rel_flat, flat_dist, 0.0)
    hint_flat = None
    if cfg.nee_hint == "on":
        hint_flat = occ_hint[None, :].expand(s, n).reshape(s * n)
    order = wavefront_sort_order(flat_o3, flat_d3, rel_flat,
                                 *scene_bounds(scene), occ_hint=hint_flat)
    return ShadowRays(permute_minor(flat_o3, order),
                      permute_minor(flat_d3, order),
                      permute_minor(flat_dist, order), order, cos,
                      permute_minor(rel_flat, order))


def _soft_visibility(origin, direction, max_dist, scene: SceneTensors,
                     cfg: RenderConfig) -> torch.Tensor:
    """The soft visibility of shadow rays [N, 3]:
    ``boundary.soft_visibility``, or under a geometry ring
    ``ring.soft_visibility_ring`` over every shard."""
    if cfg.geom_axis is not None:
        from pathtracerpython_tpu_torch.parallel.ring import (
            soft_visibility_ring,
        )

        return soft_visibility_ring(origin, direction, max_dist, scene,
                                    cfg.soft_vis_beta, cfg.geom_axis)
    # diff.boundary imports diff, whose inverse imports this module
    from pathtracerpython_tpu_torch.diff.boundary import soft_visibility

    return soft_visibility(origin, direction, max_dist, scene,
                           cfg.soft_vis_beta)


def shade_nee(hit: NearestHitCM, mat: Materials, u, scene: SceneTensors,
              cfg: RenderConfig, shading_normal3, relevant, occ_hint,
              nee_cache):
    """Direct light by next-event estimation: light_color x rgb x the mean
    unoccluded clamped cosine over ``cfg.n_light_samples`` light samples.
    ``u``: [S*5, N] uniforms. Returns (direct3 [3, N], occ_hint, nee_cache).

    Dense scenes with a light and a sample count that fit it take the
    fused kernel K2. Everything else takes the unfused NEE: the same
    estimator on the [S, N] shadow rays of ``nee_shadow_rays``, whose
    occlusion runs through ``any_hit_within_cm`` (K4 dense, K6 sparse, K9
    walker and hybrid) or, with the occluder cache, through K7; with soft
    visibility the mean is of the smooth visibility times the cosine
    (``diff/boundary.py:soft_visibility``), and the hint and cache come
    back as they went in.
    ``relevant`` and ``occ_hint`` (last bounce's all-samples-occluded bit,
    refreshed on return) only order and park the sorted sweep's lanes, and
    ``nee_cache`` (each lane's last blocking cluster, refreshed on return)
    only orders K7's work: radiance is the same either way."""
    if _fused_nee(scene, cfg):
        mean_cos = nee_mean_cos_fused(
            hit.point3, shading_normal3, u, scene, cfg.n_light_samples
        )[0][0]
        return scene.light_color[:, None] * mat.rgb3 * mean_cos[None, :], \
            occ_hint, nee_cache

    rays = nee_shadow_rays(hit, u, scene, cfg, shading_normal3, relevant,
                           occ_hint)
    if _soft(cfg):
        vis = _soft_visibility(rays.o3.T, rays.d3.T, rays.maxd, scene,
                               cfg).reshape(rays.cos.shape)
        mean_cos = (vis * rays.cos).sum(dim=0) / float(rays.cos.shape[0])
        return scene.light_color[:, None] * mat.rgb3 * mean_cos[None, :], \
            occ_hint, nee_cache
    sweep = [rays.o3.contiguous(), rays.d3.contiguous(),
             rays.maxd.contiguous(), scene]
    if _nee_cache_enabled(scene, cfg):
        # the light samples of a shading point share its guess (they
        # almost always share the occluder)
        guess = nee_cache[None, :].expand(rays.cos.shape).reshape(-1)
        if rays.order is not None:
            guess = permute_minor(guess, rays.order)
        occ_flat, blocked = sparse_any_hit_cached_cm(
            *sweep, guess.contiguous(), relevant=rays.relevant.contiguous())
        if rays.order is not None:
            blocked = unpermute_minor(blocked, rays.order)
        # any sample's blocker refreshes the cache, misses keep the guess
        upd = blocked.reshape(rays.cos.shape).amax(dim=0)
        nee_cache = torch.where(upd >= 0, upd, nee_cache)
    else:
        occ_flat = any_hit_within_cm(*sweep, accel=cfg.accel,
                                     mt_impl=cfg.mt_impl,
                                     geom_axis=cfg.geom_axis)
    if rays.order is not None:
        occ_flat = unpermute_minor(occ_flat, rays.order)
    occluded = occ_flat.reshape(rays.cos.shape)
    # parked lanes read False; they are parked again before it matters
    occ_hint = occluded.all(dim=0)
    mean_cos = torch.where(occluded, 0.0, rays.cos).sum(dim=0) / float(
        rays.cos.shape[0])
    return scene.light_color[:, None] * mat.rgb3 * mean_cos[None, :], \
        occ_hint, nee_cache


def shade_nee_reference(hit: NearestHitCM, u, scene: SceneTensors,
                        cfg: RenderConfig) -> torch.Tensor:
    """The reference estimator's direct light [3, N] (JAX
    ``render/integrator.py:239-403`` with ``mode == "reference"``):
    ``cfg.n_light_samples`` light points (triangle by area,
    normalized-uniform barycentrics), occlusion by object rows only through
    the reference any-hit, the mean over samples of the UNCLAMPED cosine
    with the raw winding normal, times light_color times the colour of the
    LAST sample's first occluder, else of the last SDL object (the
    reference's leaked loop variable). ``u``: [S*5, N] uniforms."""
    s = cfg.n_light_samples
    point3 = hit.point3
    n = point3.shape[1]
    u = u.reshape(s, 5, n)
    tri = pick_light_triangle(u[:, 0], scene.light_area)          # [S, N]
    bary = cm_sample_barycentric_reference(u[:, 1:4].transpose(0, 1))
    lv = cm_take(torch.cat([scene.light_v0.T, scene.light_v1.T,
                            scene.light_v2.T]), tri)              # [9, S, N]
    light_pt3 = cm_point_from_barycentric(bary, lv[0:3], lv[3:6], lv[6:9])
    vec3 = light_pt3 - point3[:, None, :]
    dist = torch.sqrt(cm_dot(vec3, vec3) + 1e-24)                 # [S, N]
    sdir3 = normalize3(vec3)
    cos = cm_dot(sdir3, hit.normal3[:, None, :])                  # unclamped
    occ_flat = any_hit_within_cm(
        point3[:, None, :].expand(3, s, n).reshape(3, s * n),
        sdir3.reshape(3, s * n), dist.reshape(s * n), scene,
        mode="reference", geom_axis=cfg.geom_axis)
    occluded = occ_flat.reshape(s, n)
    mean_cos = torch.where(occluded, 0.0, cos).sum(dim=0) / float(s)
    occ_idx, occ_mat = first_occluder_index(
        point3.T, sdir3[:, -1, :].T, dist[-1], scene,
        geom_axis=cfg.geom_axis)
    quirk_mat = torch.where(occ_idx >= 0, occ_mat, scene.meta.n_objects - 1)
    direct_rgb3 = cm_take(scene.mat_rgb.T, quirk_mat)
    return scene.light_color[:, None] * direct_rgb3 * mean_cos[None, :]


def shade(hit: NearestHitCM, mat: Materials, u, scene: SceneTensors,
          cfg: RenderConfig, prev_specular, shading_normal3, alive,
          occ_hint, nee_cache):
    """Per-bounce color ([3, N], occ_hint, nee_cache): surface hits pay
    ambient + NEE; a light hit pays the light color only when the path
    arrived from the camera or a specular bounce (in reference mode,
    always); a miss pays the background when ``use_background`` is set,
    else 0. Where the shadow-lane sort runs, the NEE parks the shadow rays
    of lanes whose direct term is discarded (not ``alive``, missed, light
    hits)."""
    ambient3 = mat.rgb3 * (mat.ka * scene.ambient)[None, :]
    if cfg.mode == "reference":
        direct3 = shade_nee_reference(hit, u, scene, cfg)
        light3 = scene.light_color[:, None].expand_as(direct3)
    else:
        relevant = alive & hit.hit & ~hit.is_light
        direct3, occ_hint, nee_cache = shade_nee(
            hit, mat, u, scene, cfg, shading_normal3, relevant, occ_hint,
            nee_cache)
        light3 = torch.where(prev_specular[None, :],
                             scene.light_color[:, None], 0.0)
    surface3 = ambient3 + direct3
    color3 = torch.where(hit.is_light[None, :], light3, surface3)
    if cfg.use_background:
        miss3 = scene.background[:, None].expand_as(surface3)
    else:
        miss3 = torch.zeros_like(surface3)
    return torch.where(hit.hit[None, :], color3, miss3), occ_hint, nee_cache


def arrival_side_normal(normal3, d_in3):
    """Flip the geometric normal onto the side the ray arrived from."""
    return normal3 * torch.sign(-cm_dot(normal3, d_in3) + 1e-12)[None, :]


def scatter(state: RayState, hit: NearestHitCM, mat: Materials, u,
            shading_normal3):
    """Fast-mode BRDF sampling: (new_dir3, throughput_factor, survives,
    chose_specular) for every lane. Cosine-importance diffuse about the
    shading normal or mirror reflection of the incident direction, the
    diffuse branch with probability kd/(kd+ks), factor kd+ks either way.
    ``u``: [3, N] uniforms."""
    kd, ks = mat.kd, mat.ks
    d_in3 = normalize3(state.direction3)
    diffuse_dir3 = cm_cosine_hemisphere_fixed(u[1:3], shading_normal3)
    spec_dir3 = cm_reflect(d_in3, shading_normal3)

    w = kd + ks
    p_diffuse = torch.where(w > 0.0, kd / torch.clamp_min(w, 1e-12), 1.0)
    choose_diffuse = u[0] < p_diffuse
    new_dir3 = torch.where(choose_diffuse[None, :], diffuse_dir3, spec_dir3)
    survives = hit.hit & ~hit.is_light
    return new_dir3, w, survives, ~choose_diffuse


def scatter_reference(state: RayState, hit: NearestHitCM, mat: Materials,
                      u, scene: SceneTensors):
    """The reference's BRDF sampling (JAX ``render/integrator.py:475-491``):
    (new_dir3, throughput_factor, survives, chose_specular). The branch is
    ``u0 * (kd + ks) <= kd``; diffuse is the canonical cosine sample
    rotated about the fixed y axis by arccos(normal_y), factor kd * cos;
    specular reflects the RAW previous direction (no negation), rotated the
    same way, factor ks * dot(eye_vec, dir)^n toward the eye, with numpy's
    power semantics. All on the raw winding normal. ``u``: [3, N]."""
    kd, ks = mat.kd, mat.ks
    normal3 = hit.normal3
    diffuse_dir3 = cm_rotate_frame_reference(
        cm_cosine_hemisphere_reference(u[1:3]), normal3)
    spec = normalize3(2.0 * cm_dot(normal3, state.direction3)[None, :]
                      * normal3 - state.direction3)
    spec_dir3 = cm_rotate_frame_reference(spec, normal3)
    eye_vec3 = normalize3(scene.eye[:, None] - hit.point3)
    choose_diffuse = u[0] * (kd + ks) <= kd
    new_dir3 = torch.where(choose_diffuse[None, :], diffuse_dir3, spec_dir3)
    diffuse_k = kd * cm_dot(diffuse_dir3, normal3)
    spec_k = ks * _power_numpy_semantics(cm_dot(eye_vec3, spec_dir3), mat.n)
    factor = torch.where(choose_diffuse, diffuse_k, spec_k)
    survives = hit.hit & ~hit.is_light
    return new_dir3, factor, survives, ~choose_diffuse


def sort_and_park(state: RayState, sort_bounds=None):
    """(state, sweep_o3, sweep_d3): with ``sort_bounds`` (lo3, hi3), the
    state sorted by (octant, origin morton, direction morton) with dead
    lanes last, and the rays to sweep with dead lanes parked on a ray that
    touches no cluster; without, the state and its own rays."""
    if sort_bounds is None:
        return state, state.origin3, state.direction3
    order = wavefront_sort_order(state.origin3, state.direction3,
                                 state.alive, *sort_bounds)
    state = RayState(*(permute_minor(f, order) for f in state))
    alive3 = state.alive[None, :]
    sweep_o3 = torch.where(alive3, state.origin3,
                           state.origin3.new_tensor(PARK_ORIGIN)[:, None])
    sweep_d3 = torch.where(alive3, state.direction3,
                           state.direction3.new_tensor(PARK_DIR)[:, None])
    return state, sweep_o3, sweep_d3


def _soft_record(o3, d3u, t, idx, scene: SceneTensors,
                 attrs=None) -> NearestHitCM:
    """A hit record of the soft sweep's (t, idx), IMAX for none; its
    triangle's normal, material and light flag read from the scene, or
    from ``attrs`` (``parallel.ring.SoftAttrs``: a ring's records name
    global rows)."""
    from pathtracerpython_tpu_torch.diff.boundary import IMAX

    found = idx != IMAX
    rows = torch.where(found, idx, 0).to(torch.int64)
    t = torch.where(found, t, 0.0)
    if attrs is None:
        normal3 = cm_take(scene.tri_normal.T, rows)
        material, is_light = scene.tri_material[rows], scene.tri_is_light[rows]
    else:
        normal3, material, is_light = attrs
    return NearestHitCM(
        hit=found,
        t=t,
        tri_idx=rows.to(torch.int32),
        point3=o3 + d3u * t[None, :],
        normal3=normal3,
        material=material,
        is_light=is_light & found,
    )


def _soft_hits(o3, d3, scene: SceneTensors, cfg: RenderConfig):
    """The soft sweep's records of rays (o3, d3) [3, N] and their
    triangles' attributes: ``boundary.soft_hits_sweep`` and None, or under
    a geometry ring ``ring.soft_hits_ring``'s records and attributes."""
    if cfg.geom_axis is not None:
        from pathtracerpython_tpu_torch.parallel.ring import soft_hits_ring

        return soft_hits_ring(o3.T, d3.T, scene, cfg.soft_vis_beta,
                              cfg.geom_axis)
    from pathtracerpython_tpu_torch.diff.boundary import soft_hits_sweep

    return soft_hits_sweep(o3.T, d3.T, scene, cfg.soft_vis_beta), None


def _soft_hit_and_shade(o3, d3, state: RayState, scene: SceneTensors,
                        cfg: RenderConfig, u_nee):
    """The soft estimator's hit and colour (``soft_vis_beta > 0``, the
    math in ``diff/boundary.py``): (the first true hit, for the path to go
    on from, and the colour ``cov * shade(front) + (1 - cov) *
    shade(behind)`` [3, N]). The blend makes the radiance continuous in the
    occluders' vertices: gradients flow through the front record's edge
    margin and through both hits' distances. ``o3``, ``d3``: the rays to
    sweep (sorted and parked as the hard sweep takes them)."""
    sh, attrs = _soft_hits(o3, d3, scene, cfg)
    d3u = normalize3(d3)
    at = attrs or {}
    front = _soft_record(o3, d3u, sh.f_t, sh.f_idx, scene, at.get("f"))
    # behind: the first true hit past the front record, hit2 where the
    # front is hit1, else hit1 (the front is then a near-miss before it)
    front_is_h1 = sh.f_idx == sh.h1_idx
    behind_attrs = (None if attrs is None
                    else attrs["h2"].where(front_is_h1, attrs["h1"]))
    behind = _soft_record(o3, d3u,
                          torch.where(front_is_h1, sh.h2_t, sh.h1_t),
                          torch.where(front_is_h1, sh.h2_idx, sh.h1_idx),
                          scene, behind_attrs)
    cov = torch.where(front.hit, torch.sigmoid(sh.f_margin
                                               / cfg.soft_vis_beta), 0.0)

    def shade_record(r: NearestHitCM):
        # soft shadows touch neither the hint nor the occluder cache
        n3 = arrival_side_normal(r.normal3, d3u)
        return shade(r, resolve_materials(scene, r.material), u_nee, scene,
                     cfg, state.prev_specular, n3, state.alive,
                     state.nee_occ_hint, state.nee_cache)[0]

    color3 = (cov[None, :] * shade_record(front)
              + (1.0 - cov)[None, :] * shade_record(behind))
    return (_soft_record(o3, d3u, sh.h1_t, sh.h1_idx, scene, at.get("h1")),
            color3)


def bounce_step(state: RayState, bounce_idx: int, scene: SceneTensors,
                cfg: RenderConfig, k0: int, k1: int,
                sort_bounds=None) -> RayState:
    """One wavefront bounce: intersect -> shade -> scatter, fully masked.

    ``sort_bounds``: (lo3, hi3) scene bounds when wavefront sorting is on:
    the state is re-sorted by (octant, origin morton, direction morton) and
    the sweep parks dead lanes on a ray that touches no cluster; a pure
    lane permutation (the counters carry the RNG), so the radiance equals
    the unsorted path's."""
    count("lane_bounces", state.alive.numel())
    count("live_lane_bounces", state.alive)
    with span("ptt.sort"):
        state, sweep_o3, sweep_d3 = sort_and_park(state, sort_bounds)
    nk0, nk1 = rng.fold(k0, k1, bounce_idx * 4 + _P_NEE)
    sk0, sk1 = rng.fold(k0, k1, bounce_idx * 4 + _P_SCATTER)
    u_nee = rng.uniforms(nk0, nk1, state.counters, cfg.n_light_samples * 5)
    u_scatter = rng.uniforms(sk0, sk1, state.counters, 3)

    d_in3 = normalize3(state.direction3)
    if _soft(cfg):
        hit, color3 = _soft_hit_and_shade(sweep_o3, sweep_d3, state, scene,
                                          cfg, u_nee)
        mat = resolve_materials(scene, hit.material)
        shading_n3 = arrival_side_normal(hit.normal3, d_in3)
        occ_hint, nee_cache = state.nee_occ_hint, state.nee_cache
    else:
        with span("ptt.nearest"):
            hit = nearest_hit_cm(sweep_o3, sweep_d3, scene, accel=cfg.accel,
                                 mt_impl=cfg.mt_impl, mode=cfg.mode,
                                 geom_axis=cfg.geom_axis)
        mat = resolve_materials(scene, hit.material)
        # one arrival-side normal for both direct light and scattering;
        # reference mode keeps the raw winding normal
        shading_n3 = (arrival_side_normal(hit.normal3, d_in3)
                      if cfg.mode == "fast" else hit.normal3)
        with span("ptt.nee"):
            color3, occ_hint, nee_cache = shade(
                hit, mat, u_nee, scene, cfg, state.prev_specular, shading_n3,
                state.alive, state.nee_occ_hint, state.nee_cache)
    with span("ptt.scatter"):
        contrib3 = torch.where(
            state.alive[None, :], color3 * state.throughput[None, :], 0.0
        )
        radiance3 = state.radiance3 + contrib3

        if cfg.mode == "reference":
            new_dir3, factor, survives, chose_spec = scatter_reference(
                state, hit, mat, u_scatter, scene)
        else:
            new_dir3, factor, survives, chose_spec = scatter(
                state, hit, mat, u_scatter, shading_n3)
        alive = state.alive & survives
        return RayState(
            origin3=torch.where(alive[None, :], hit.point3, state.origin3),
            direction3=torch.where(alive[None, :], new_dir3, state.direction3),
            throughput=torch.where(alive, state.throughput * factor,
                                   state.throughput),
            alive=alive,
            radiance3=radiance3,
            counters=state.counters,
            prev_specular=state.alive & chose_spec,
            nee_occ_hint=occ_hint,
            nee_cache=nee_cache,
            lane=state.lane,
        )


def init_rays(origins3, directions3, counters) -> RayState:
    """Fresh primary-ray state. ``counters``: global path ids."""
    n = origins3.shape[1]
    device = origins3.device
    return RayState(
        origin3=origins3.contiguous(),
        direction3=directions3.contiguous(),
        throughput=torch.ones(n, dtype=origins3.dtype, device=device),
        alive=torch.ones(n, dtype=torch.bool, device=device),
        radiance3=torch.zeros((3, n), dtype=origins3.dtype, device=device),
        counters=counters.to(torch.int64),
        prev_specular=torch.ones(n, dtype=torch.bool, device=device),
        nee_occ_hint=torch.zeros(n, dtype=torch.bool, device=device),
        nee_cache=torch.full((n,), -1, dtype=torch.int32, device=device),
        lane=torch.arange(n, dtype=torch.int64, device=device),
    )


def _bounce_sweep(state: RayState, scene, cfg, k0, k1,
                  sort_bounds) -> RayState:
    """The bounces; with ``cfg.remat_bounces`` and grad on, each under
    ``torch.utils.checkpoint`` (under a geometry ring bound to its mesh,
    whose recompute re-sends the bounce's forward shifts in the middle of
    the reverse ones, at the same point on every rank)."""
    remat = cfg.remat_bounces and torch.is_grad_enabled()
    step = bounce_step
    if remat and cfg.geom_axis is not None:
        # the recompute runs inside the backward, after the sharded
        # render's mesh.active block has exited
        from pathtracerpython_tpu_torch.parallel.mesh import carrying

        step = carrying(bounce_step)
    for b in range(cfg.n_bounces):
        with span("ptt.bounce"):
            if remat:
                state = checkpoint(step, state, b, scene, cfg, k0, k1,
                                   sort_bounds, use_reentrant=False)
            else:
                state = bounce_step(state, b, scene, cfg, k0, k1,
                                    sort_bounds)
    return state


def _unscramble(state: RayState) -> torch.Tensor:
    """The radiance [3, lanes] back in the order ``init_rays`` made the
    lanes, after any number of sorts: each lane carries its place
    (``state.lane``: sample * n + position for batch_samples, the position
    otherwise), whatever its pixel id."""
    # in place into a fresh buffer that autograd saved nowhere: the
    # backward gathers the radiance's gradient by ``lane``
    out = torch.zeros_like(state.radiance3)
    return out.index_copy_(1, state.lane, state.radiance3)


def render_rays(origins, directions, pixel_ids, scene: SceneTensors,
                cfg: RenderConfig, base_key) -> torch.Tensor:
    """Trace the given primary rays [N, 3]; return radiance [N, 3], the
    mean over ``cfg.n_samples`` sample passes. ``base_key``: an int seed or
    a (k0, k1) key (``ops.rng.split``), as the JAX package takes a seed or
    a ``PRNGKey``.

    Two plans with identical results (the RNG stream depends only on
    (pixel, sample)): a loop over samples (minimal memory) or
    ``cfg.batch_samples`` (all spp as extra lanes, fewer kernel launches,
    n_samples x the live state)."""
    n = origins.shape[0]
    s_total = cfg.n_samples
    check_counter_space(n, s_total)
    o3 = origins.T
    d3 = directions.T
    pid = pixel_ids.to(torch.int64)
    k0, k1 = rng.key_from_seed(base_key)
    sort_bounds = scene_bounds(scene) if _sort_enabled(scene, cfg) else None

    def sweep(state: RayState) -> torch.Tensor:
        state = _bounce_sweep(state, scene, cfg, k0, k1, sort_bounds)
        if sort_bounds is None:
            return state.radiance3
        return _unscramble(state)

    passes = []
    if cfg.batch_samples and s_total > 1:
        counters = torch.cat([pid * s_total + s for s in range(s_total)])
        state = init_rays(o3.repeat(1, s_total), d3.repeat(1, s_total),
                          counters)
        radiance3 = sweep(state)
        passes = [radiance3[:, s * n:(s + 1) * n] for s in range(s_total)]
    else:
        for s in range(s_total):
            state = init_rays(o3, d3, pid * s_total + s)
            passes.append(sweep(state))
    total3 = passes[0]
    for p in passes[1:]:
        total3 = total3 + p
    return (total3 / s_total).T


def check_counter_space(n_pixels: int, n_samples: int) -> None:
    """Path counters are 32-bit (pixel_id * spp + sample); past 2^32 they
    would alias RNG streams across paths — refuse instead."""
    if n_pixels * n_samples >= 2**32:
        raise ValueError(
            f"pixels*samples = {n_pixels}*{n_samples} overflows the 32-bit "
            "path counter space; tile the image or split the samples"
        )


def render(scene: SceneTensors, cfg: RenderConfig, seed: int = 0):
    """Render the scene's camera view on the scene's device; returns
    radiance [W*H, 3] in the reference's pixel order (x-outer / y-inner)."""
    w, h = scene.meta.width, scene.meta.height
    check_counter_space(w * h, cfg.n_samples)
    with span("ptt.camera"):
        origins, dirs = make_primary_rays(scene.eye, scene.ortho, w, h)
    pixel_ids = torch.arange(w * h, dtype=torch.int64, device=scene.device)
    return render_rays(origins, dirs, pixel_ids, scene, cfg, seed)


def render_image(scene: SceneTensors, cfg: RenderConfig, seed: int = 0):
    """Render and convert to a uint8 image with reference normalization."""
    from pathtracerpython_tpu_torch.render.image import radiance_to_image

    radiance = render(scene, cfg, seed=seed)
    return radiance_to_image(radiance, scene.meta.width, scene.meta.height)
