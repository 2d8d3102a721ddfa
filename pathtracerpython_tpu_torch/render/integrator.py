"""The fast-mode wavefront path-tracing integrator (component-major layout).

The forward fast-mode path of the JAX package's ``render/integrator.py``:

    for each sample:                  (a Python loop, or extra lanes)
        state = primary rays          (ops.camera)
        for each bounce:              (a Python loop)
            hit   = nearest_hit_cm    (K1: kernels/intersect.py)
            color = shade(hit)        (ambient + fused NEE, K2: kernels/nee.py)
            state = scatter(hit)      (diffuse/specular branch, masked)

Every per-ray vector is float32 [3, N]; dead rays are masked lanes. The
RNG is the counter-based Threefry keyed by the global path id
``pixel_id * n_samples + sample``, bit-equal to the JAX package's, so both
plans (per-sample loop and ``batch_samples``) draw the same numbers and
give the same radiance. The render runs on the device the scene lives on.

Not ported yet, and refused with ``NotImplementedError`` naming the
ROADMAP item (``check_supported``): reference mode, the sparse / walker /
hybrid hierarchies, the unfused NEE (more than 64 light triangles), soft
visibility, geometry sharding, ray sorting and the occluder cache, and
rematerialized bounces.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pathtracerpython_tpu_torch.kernels.nee import (
    FUSED_NEE_MAX_LIGHT_TRIS,
    MAX_LIGHT_SAMPLES,
    nee_mean_cos_fused,
)
from pathtracerpython_tpu_torch.ops import rng
from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
from pathtracerpython_tpu_torch.ops.gather import cm_take
from pathtracerpython_tpu_torch.ops.geometry import (
    NearestHitCM,
    nearest_hit_cm,
    normalize3,
)
from pathtracerpython_tpu_torch.ops.sampling import (
    cm_cosine_hemisphere_fixed,
    cm_dot,
    cm_reflect,
)
from pathtracerpython_tpu_torch.render.config import RenderConfig
from pathtracerpython_tpu_torch.scene.arrays import SceneTensors

# purpose salts for per-bounce key derivation
_P_NEE = 0
_P_SCATTER = 1

# Scenes from this many padded triangles up resolve accel="auto" to the
# hybrid hierarchy (kernels/sparse_pallas.py:SPARSE_MIN_TRIS in the JAX
# package).
SPARSE_MIN_TRIS = 4096


class RayState(NamedTuple):
    """Per-ray wavefront state; vectors are component-major [3, N]."""

    origin3: torch.Tensor      # f32[3, N]
    direction3: torch.Tensor   # f32[3, N] raw dir (primaries unnormalized)
    throughput: torch.Tensor   # f32[N]
    alive: torch.Tensor        # bool[N]
    radiance3: torch.Tensor    # f32[3, N] accumulated pixel color
    counters: torch.Tensor     # i64[N] global path id = pixel_id * spp + sample
    prev_specular: torch.Tensor  # bool[N] (fast-mode emission rule)


class Materials(NamedTuple):
    """Per-ray material properties (resolved once per bounce)."""

    rgb3: torch.Tensor  # f32[3, N]
    ka: torch.Tensor    # f32[N]
    kd: torch.Tensor    # f32[N]
    ks: torch.Tensor    # f32[N]
    n: torch.Tensor     # f32[N]


def resolve_accel(accel: str, n_padded_tris: int) -> str:
    """The hierarchy ``accel`` selects: "auto" is the hybrid for scenes
    of SPARSE_MIN_TRIS padded triangles and more, "none" below."""
    if accel == "auto":
        return "hybrid" if n_padded_tris >= SPARSE_MIN_TRIS else "none"
    return accel


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to pathtracerpython_tpu_torch yet "
        f"(ROADMAP.md queue A, {item})"
    )


def check_supported(scene: SceneTensors, cfg: RenderConfig) -> None:
    """Refuse every configuration this port cannot render with the same
    semantics as the JAX package, naming the ROADMAP item that adds it."""
    if cfg.mode != "fast":
        _not_ported(f"mode={cfg.mode!r}", "item 6: reference mode")
    resolved = resolve_accel(cfg.accel, scene.num_padded_triangles)
    if resolved != "none":
        _not_ported(f"accel={cfg.accel!r} (resolves to {resolved!r})",
                    "item 7: the large-scene slice")
    if scene.light_area.shape[0] > FUSED_NEE_MAX_LIGHT_TRIS:
        _not_ported(
            f"a light of {scene.light_area.shape[0]} triangles (more than "
            f"{FUSED_NEE_MAX_LIGHT_TRIS}: the unfused NEE)",
            "item 5: the unfused NEE with the any-hit kernel K4",
        )
    if cfg.n_light_samples > MAX_LIGHT_SAMPLES:
        _not_ported(
            f"n_light_samples={cfg.n_light_samples} (more than "
            f"{MAX_LIGHT_SAMPLES}: the unfused NEE)",
            "item 5: the unfused NEE with the any-hit kernel K4",
        )
    if cfg.soft_vis_beta > 0.0:
        _not_ported("soft_vis_beta > 0", "item 8: diff")
    if cfg.remat_bounces:
        _not_ported("remat_bounces=True", "item 8: diff")
    if cfg.geom_axis is not None:
        _not_ported("geom_axis", "item 9: parallel")
    if cfg.nee_cache == "on":
        _not_ported("nee_cache='on'", "item 7: the large-scene slice")
    if cfg.sort_rays == "on":
        _not_ported("sort_rays='on'", "item 7: the large-scene slice")


def resolve_materials(scene: SceneTensors, material) -> Materials:
    rgb3 = cm_take(scene.mat_rgb.T, material)
    scalars = cm_take(
        torch.stack([scene.mat_ka, scene.mat_kd, scene.mat_ks, scene.mat_n]),
        material,
    )
    return Materials(
        rgb3=rgb3, ka=scalars[0], kd=scalars[1], ks=scalars[2], n=scalars[3],
    )


def shade_nee(hit: NearestHitCM, mat: Materials, u, scene: SceneTensors,
              cfg: RenderConfig, shading_normal3) -> torch.Tensor:
    """Direct light by next-event estimation through the fused kernel K2:
    light_color x rgb x the mean unoccluded clamped cosine over
    ``cfg.n_light_samples`` light samples. ``u``: [S*5, N] uniforms."""
    mean_cos = nee_mean_cos_fused(
        hit.point3, shading_normal3, u, scene, cfg.n_light_samples
    )[0][0]
    return scene.light_color[:, None] * mat.rgb3 * mean_cos[None, :]


def shade(hit: NearestHitCM, mat: Materials, u, scene: SceneTensors,
          cfg: RenderConfig, prev_specular, shading_normal3) -> torch.Tensor:
    """Per-bounce color [3, N]: surface hits pay ambient + NEE; a light hit
    pays the light color only when the path arrived from the camera or a
    specular bounce; a miss pays the background when ``use_background``
    is set, else 0."""
    ambient3 = mat.rgb3 * (mat.ka * scene.ambient)[None, :]
    surface3 = ambient3 + shade_nee(hit, mat, u, scene, cfg, shading_normal3)
    light3 = torch.where(prev_specular[None, :], scene.light_color[:, None],
                         0.0)
    color3 = torch.where(hit.is_light[None, :], light3, surface3)
    if cfg.use_background:
        miss3 = scene.background[:, None].expand_as(surface3)
    else:
        miss3 = torch.zeros_like(surface3)
    return torch.where(hit.hit[None, :], color3, miss3)


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


def bounce_step(state: RayState, bounce_idx: int, scene: SceneTensors,
                cfg: RenderConfig, k0: int, k1: int) -> RayState:
    """One wavefront bounce: intersect -> shade -> scatter, fully masked."""
    nk0, nk1 = rng.fold(k0, k1, bounce_idx * 4 + _P_NEE)
    sk0, sk1 = rng.fold(k0, k1, bounce_idx * 4 + _P_SCATTER)
    u_nee = rng.uniforms(nk0, nk1, state.counters, cfg.n_light_samples * 5)
    u_scatter = rng.uniforms(sk0, sk1, state.counters, 3)

    hit = nearest_hit_cm(state.origin3, state.direction3, scene)
    mat = resolve_materials(scene, hit.material)
    # one arrival-side normal for both direct light and scattering
    shading_n3 = arrival_side_normal(hit.normal3, normalize3(state.direction3))
    color3 = shade(hit, mat, u_nee, scene, cfg, state.prev_specular,
                   shading_n3)
    contrib3 = torch.where(
        state.alive[None, :], color3 * state.throughput[None, :], 0.0
    )
    radiance3 = state.radiance3 + contrib3

    new_dir3, factor, survives, chose_spec = scatter(
        state, hit, mat, u_scatter, shading_n3
    )
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
    )


def _bounce_sweep(state: RayState, scene, cfg, k0, k1) -> RayState:
    for b in range(cfg.n_bounces):
        state = bounce_step(state, b, scene, cfg, k0, k1)
    return state


def render_rays(origins, directions, pixel_ids, scene: SceneTensors,
                cfg: RenderConfig, base_key: int) -> torch.Tensor:
    """Trace the given primary rays [N, 3]; return radiance [N, 3], the
    mean over ``cfg.n_samples`` sample passes.

    Two plans with identical results (the RNG stream depends only on
    (pixel, sample)): a loop over samples (minimal memory) or
    ``cfg.batch_samples`` (all spp as extra lanes, fewer kernel launches,
    n_samples x the live state)."""
    check_supported(scene, cfg)
    n = origins.shape[0]
    s_total = cfg.n_samples
    check_counter_space(n, s_total)
    o3 = origins.T
    d3 = directions.T
    pid = pixel_ids.to(torch.int64)
    k0, k1 = rng.key_from_seed(base_key)

    passes = []
    if cfg.batch_samples and s_total > 1:
        counters = torch.cat([pid * s_total + s for s in range(s_total)])
        state = init_rays(o3.repeat(1, s_total), d3.repeat(1, s_total),
                          counters)
        radiance3 = _bounce_sweep(state, scene, cfg, k0, k1).radiance3
        passes = [radiance3[:, s * n:(s + 1) * n] for s in range(s_total)]
    else:
        for s in range(s_total):
            state = init_rays(o3, d3, pid * s_total + s)
            passes.append(_bounce_sweep(state, scene, cfg, k0, k1).radiance3)
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
    origins, dirs = make_primary_rays(scene.eye, scene.ortho, w, h)
    pixel_ids = torch.arange(w * h, dtype=torch.int64, device=scene.device)
    return render_rays(origins, dirs, pixel_ids, scene, cfg, seed)


def render_image(scene: SceneTensors, cfg: RenderConfig, seed: int = 0):
    """Render and convert to a uint8 image with reference normalization."""
    from pathtracerpython_tpu_torch.render.image import radiance_to_image

    radiance = render(scene, cfg, seed=seed)
    return radiance_to_image(radiance, scene.meta.width, scene.meta.height)
