"""Differentiable rigid transforms of scene objects (the JAX package's
``diff/transforms.py``): smooth maps from pose parameters to a moved
``SceneTensors``.

- ``translate_object``: rigid translation of one material's triangles;
- ``rotate_object``: axis-angle rotation about the object's centroid
  (Rodrigues form, smooth in the angle everywhere, 0 included);
- ``transform_object``: rotation, then translation (4 degrees of freedom);
- ``rotate_object_euler`` / ``transform_object_full``: yaw, pitch, roll
  about the centroid, then a free translation (6 degrees of freedom).

Every map ends in ``recompute_derived``, so normals and areas carry
gradients (translation alone keeps them, rotation does not).
"""

from __future__ import annotations

import dataclasses

import torch

from pathtracerpython_tpu_torch.scene.arrays import (
    SceneTensors,
    recompute_derived,
)


def _object_mask(scene: SceneTensors, obj_index: int) -> torch.Tensor:
    return (scene.tri_material == obj_index) & scene.tri_valid


def _vec(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (a tensor, which keeps its graph, or numbers) as a tensor of
    ``like``'s dtype on its device."""
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def object_centroid(scene: SceneTensors, obj_index: int) -> torch.Tensor:
    """Mean of the object's triangle vertices, f32[3]."""
    m = _object_mask(scene, obj_index).to(scene.tri_v0.dtype)[:, None]
    total = m.sum() * 3.0
    s = ((scene.tri_v0 * m).sum(dim=0) + (scene.tri_v1 * m).sum(dim=0)
         + (scene.tri_v2 * m).sum(dim=0))
    return s / torch.clamp_min(total, 1.0)


def _rodrigues(v: torch.Tensor, axis_unit: torch.Tensor, angle) -> torch.Tensor:
    """Rotate rows of ``v`` [T, 3] by ``angle`` about ``axis_unit`` [3]."""
    c = torch.cos(angle)
    s = torch.sin(angle)
    k = axis_unit[None, :]
    kxv = torch.linalg.cross(k.expand_as(v), v, dim=-1)
    kdv = (v * k).sum(dim=-1, keepdim=True)
    return v * c + kxv * s + k * kdv * (1.0 - c)


def _moved(scene: SceneTensors, move) -> SceneTensors:
    return recompute_derived(dataclasses.replace(
        scene, tri_v0=move(scene.tri_v0), tri_v1=move(scene.tri_v1),
        tri_v2=move(scene.tri_v2)))


def translate_object(scene: SceneTensors, obj_index: int,
                     offset) -> SceneTensors:
    """Shift every triangle of material row ``obj_index`` by ``offset``
    [3], differentiably. Normals and areas are recomputed anyway, so that
    every map takes one path."""
    mask = _object_mask(scene, obj_index)
    shift = torch.where(mask[:, None], 1.0, 0.0) * _vec(
        offset, scene.tri_v0)[None, :]
    return _moved(scene, lambda v: v + shift)


def rotate_object(scene: SceneTensors, obj_index: int, angle,
                  axis=(0.0, 1.0, 0.0), center=None) -> SceneTensors:
    """Rotate one object by ``angle`` (radians) about ``axis`` through
    ``center`` (default: the object's centroid); differentiable in the
    angle and the vertices."""
    axis_u = _vec(axis, scene.tri_v0)
    axis_u = axis_u / torch.sqrt((axis_u * axis_u).sum() + 1e-30)
    if center is None:
        center = object_centroid(scene, obj_index)
    c = _vec(center, scene.tri_v0)[None, :]
    mask = _object_mask(scene, obj_index)[:, None]
    angle = _vec(angle, scene.tri_v0)
    return _moved(scene, lambda v: torch.where(
        mask, _rodrigues(v - c, axis_u, angle) + c, v))


def transform_object(scene: SceneTensors, obj_index: int, offset, angle,
                     axis=(0.0, 1.0, 0.0)) -> SceneTensors:
    """Rotate about the object's (original) centroid, then translate: the
    4-dof pose of the JAX package's ``apps.fit_pose --object``."""
    rotated = rotate_object(scene, obj_index, angle, axis=axis)
    return translate_object(rotated, obj_index, offset)


def rotate_object_euler(scene: SceneTensors, obj_index: int, angles,
                        center=None) -> SceneTensors:
    """Full rotation by ``angles = (yaw, pitch, roll)``, the composed map
    R = Ry(yaw) Rx(pitch) Rz(roll) about ``center`` (default: the object's
    centroid); differentiable in every angle."""
    angles = _vec(angles, scene.tri_v0)
    if center is None:
        center = object_centroid(scene, obj_index)
    c = _vec(center, scene.tri_v0)[None, :]
    mask = _object_mask(scene, obj_index)[:, None]
    ax_y, ax_x, ax_z = (_vec(a, scene.tri_v0) for a in (
        (0.0, 1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0)))

    def rot(v):
        p = v - c
        p = _rodrigues(p, ax_z, angles[2])   # roll
        p = _rodrigues(p, ax_x, angles[1])   # pitch
        p = _rodrigues(p, ax_y, angles[0])   # yaw
        return torch.where(mask, p + c, v)

    return _moved(scene, rot)


def transform_object_full(scene: SceneTensors, obj_index: int, offset,
                          angles) -> SceneTensors:
    """Full 6-dof rigid pose: yaw, pitch and roll about the (original)
    centroid, then a free 3-d translation."""
    rotated = rotate_object_euler(scene, obj_index, angles)
    return translate_object(rotated, obj_index, offset)
