"""The redesigned probes' plain side on the CPU: P1's TF32 tiles (the
split operands its tensor-core kernels copy whole), ``inside_pairs``
against the sides of the JAX probe's own packs and on a culled sweep, and
P2's packed-compare form against its float32-compare form, bit for bit;
the probes' C entries against their ctypes argument types. The kernels
themselves run on the card (``tests/test_torch_cuda.py``)."""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import os

import numpy as np
import pytest
import torch

from pathtracerpython_tpu_torch.kernels import build
from pathtracerpython_tpu_torch.probes import bf16_probe, mma_probe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _tile_value(tiles, part: int, row: int, k: int) -> torch.Tensor:
    """Value (row, k) of part ``part`` (0-6) of ``tf32_tiles``' layout,
    addressed as csrc/probe_plucker.cu addresses it."""
    tile, r = divmod(row, mma_probe.MMA_ROWS)
    if part == 3:   # the plane rows: row-major
        return tiles[tile, 3 * 512 + r * 8 + k]
    at = (r // 8) * 64 + (k // 4) * 32 + (r % 8) * 4 + k % 4
    return tiles[tile, part * 512 + at]


@pytest.mark.parametrize("n_tris", [128, 100])
def test_tf32_tiles_split_each_operand_once(n_tris):
    """hi is ``tf32(x)``, lo is ``tf32(x - hi)``, hi + lo is x within
    2^-21 relative; the plane rows are the pack's columns 24-31; rows past
    T are zero (so not valid)."""
    _, _, tripack = mma_probe.make_inputs(16, n_tris, seed=5)
    packs = mma_probe.make_packs(tripack)
    tiles, pack36 = packs.tiles, packs.pack36
    n_tiles = -(-n_tris // mma_probe.MMA_ROWS)
    assert tiles.shape == (n_tiles, mma_probe.TILE_FLOATS)
    index = torch.tensor([[[(r // 8) * 64 + (k // 4) * 32 + (r % 8) * 4
                            + k % 4 for k in range(8)] for r in range(64)]])
    padded = torch.zeros(n_tiles * 64, 36)
    padded[:n_tris] = pack36
    for e in range(3):
        x = padded[:, 8 * e:8 * e + 8].reshape(n_tiles, 64, 8)
        hi = torch.gather(tiles[:, e * 512:(e + 1) * 512], 1,
                          index.reshape(1, -1).expand(n_tiles, -1))
        lo = torch.gather(tiles[:, (4 + e) * 512:(5 + e) * 512], 1,
                          index.reshape(1, -1).expand(n_tiles, -1))
        hi, lo = hi.reshape(n_tiles, 64, 8), lo.reshape(n_tiles, 64, 8)
        assert torch.equal(hi, mma_probe.tf32(x))
        assert torch.equal(lo, mma_probe.tf32(x - hi))
        # the low 13 bits of every operand are zero: TF32 values
        for part in (hi, lo):
            assert not bool((part.view(torch.int32) & 0x1FFF).any())
        err = ((hi.double() + lo.double()) - x.double()).abs()
        assert bool((err <= 2.0 ** -21 * x.double().abs()).all())
        assert float(lo.abs().max()) > 0
    plane = tiles[:, 3 * 512:4 * 512].reshape(n_tiles * 64, 8)
    assert torch.equal(plane, padded[:, 24:32])
    assert not bool(plane[n_tris:].any())
    # spot checks through the kernel's own addressing
    for row, k in ((0, 0), (9, 5), (n_tris - 1, 7), (63 % n_tris, 4)):
        assert _tile_value(tiles, 1, row, k) == mma_probe.tf32(
            pack36[row, 8 + k:9 + k])[0]
        assert _tile_value(tiles, 3, row, k) == pack36[row, 24 + k]


def _jax_probe_packs(v0, v1, v2):
    """The JAX probe's own edge packs E[3][T, 8] (``scripts/mxu_probe.py:
    build``'s ``tri_pack_plucker``), as numpy arrays."""
    spec = importlib.util.spec_from_file_location(
        "mxu_probe_under_test", os.path.join(ROOT, "scripts", "mxu_probe.py"))
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    tri_pack_plucker = probe.build(argparse.Namespace(tris=v0.shape[0]))[1]
    epacks, _ = tri_pack_plucker(v0, v1, v2)
    return [np.asarray(e, np.float32) for e in epacks]


def test_inside_pairs_counts_the_jax_packs_sides():
    """``inside_pairs`` counts the (ray, row) pairs whose three sides,
    taken from the JAX probe's packs and the rays with numpy in float32 in
    the kernels' order, agree in sign; the port's pack holds the same edge
    rows."""
    o3, d3, tripack = mma_probe.make_inputs(2048, 96, seed=7)
    v = [tripack[:, 3 * k:3 * k + 3].numpy() for k in range(3)]
    epacks = _jax_probe_packs(*v)
    pack36 = mma_probe.make_packs(tripack).pack36
    assert np.array_equal(np.concatenate(epacks, axis=1),
                          pack36[:, :24].numpy())
    o, d = o3.numpy(), d3.numpy()
    ox, oy, oz = o[0:1], o[1:2], o[2:3]
    dx, dy, dz = d[0:1], d[1:2], d[2:3]
    ray = [oy * dz - oz * dy, oz * dx - ox * dz, ox * dy - oy * dx, dx, dy,
           dz]
    sides = []
    for e in epacks:
        s = e[:, 0:1] * ray[0]
        for c in range(1, 6):
            s = s + e[:, c:c + 1] * ray[c]
        sides.append(s)
    s0, s1, s2 = sides
    inside = (((s0 >= 0) & (s1 >= 0) & (s2 >= 0))
              | ((s0 <= 0) & (s1 <= 0) & (s2 <= 0)))
    want = int(inside.sum())
    pairs, got = mma_probe.inside_pairs(o3, d3, pack36)
    assert pairs == inside.size and got == want
    # the probe's inputs: a few in a thousand pairs, most of them misses of
    # the plane or behind the origin
    assert 5e-4 < got / inside.size < 5e-3
    hits = int((mma_probe.probe_plain(o3, d3, tripack, "plucker_fma")[1]
                != mma_probe.IMAX).sum())
    assert 0 < hits < got
    # an invalid row is not counted
    pack36[:48, 30] = 0.0
    assert mma_probe.inside_pairs(o3, d3, pack36) == (
        inside[48:].size, int(inside[48:].sum()))


def test_inside_pairs_on_a_culled_sweep():
    """With the nearest sweep's cull boxes and each lane's winner, the
    pairs counted are those a culled sweep tests once its best is its
    winner: the winner's own pair among them and inside, no more than the
    culled model tests; with boxes that hold everything, every pair."""
    from pathtracerpython_tpu_torch.kernels import intersect
    from pathtracerpython_tpu_torch.ops.camera import make_primary_rays
    from pathtracerpython_tpu_torch.scene.arrays import pack_scene
    from pathtracerpython_tpu_torch.scene.synthetic import cornell_box_scene

    scene = pack_scene(cornell_box_scene(16, 16), pad_to=32, device="cpu")
    origins, dirs = make_primary_rays(scene.eye, scene.ortho, 16, 16)
    o3 = origins.T.contiguous()
    d3 = (dirs / dirs.norm(dim=1, keepdim=True)).T.contiguous()
    tripack = intersect.scene_tripack(scene)
    pack = intersect.scene_plucker_pack(scene)
    cull = intersect.nearest_cull_boxes(tripack)
    tested = []
    t, idx = intersect.nearest_t_idx_plain(o3, d3, pack, intersect.PLUCKER,
                                           cull, tested)
    reach = torch.where(idx >= 0, t, intersect.BIG)
    met, inside_met = mma_probe.inside_pairs(o3, d3, pack, cull, reach)
    every, inside_all = mma_probe.inside_pairs(o3, d3, pack)
    hits = int((idx >= 0).sum())
    assert 0 < hits <= inside_met <= met <= tested[0] < every
    assert inside_met <= inside_all
    huge = torch.tensor([-1e30] * 3 + [1e30] * 3 + [0.0, 0.0])
    everything = intersect.CullBoxes(
        huge.expand_as(cull.tile).contiguous(),
        huge.expand_as(cull.group).contiguous())
    assert mma_probe.inside_pairs(o3, d3, pack, everything, reach) == (
        every, inside_all)


def _below_bf16(x: float) -> torch.Tensor:
    """The largest bf16 value not above the positive float32 ``x``."""
    bits = torch.tensor([x], dtype=torch.float32).view(torch.int32)
    return (bits & ~0xFFFF).view(torch.float32).to(torch.bfloat16)[0]


def _bf16_count_packed_compare(o3, d3, tripack) -> torch.Tensor:
    """P2's bf16 sweep in the kernel's compare form: ``hit_count_plain``'s
    bf16 operations, but u >= 0, v >= 0, t > T_MIN and |det| > DET_EPS
    compared in bf16 against the largest bf16 values not above the
    thresholds, u + v summed in float32 on the widened values, and the
    reciprocal of every det taken, parallel or not (no counted pair reads
    it)."""
    bf16 = torch.bfloat16
    ox, oy, oz = (o3[k:k + 1].to(bf16) for k in range(3))
    dx, dy, dz = (d3[k:k + 1].to(bf16) for k in range(3))
    col = lambda c: tripack[:, c:c + 1].to(bf16)
    v0x, v0y, v0z = col(0), col(1), col(2)
    e1x, e1y, e1z = col(3) - v0x, col(4) - v0y, col(5) - v0z
    e2x, e2y, e2z = col(6) - v0x, col(7) - v0y, col(8) - v0z
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    not_par = det.abs() > _below_bf16(bf16_probe.DET_EPS)
    inv_det = (1.0 / det.float()).to(bf16)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    zero = torch.zeros((), dtype=bf16)
    inside = (u >= zero) & (v >= zero) & (t > _below_bf16(bf16_probe.T_MIN))
    hit = (not_par & inside & (u.float() + v.float() <= 1.0)
           & (tripack[:, 9:10] > 0.5))
    return hit.sum(dim=0, dtype=torch.float32)


def test_bf16_packed_compare_form_equals_the_f32_compare_form():
    """P2's bf16 sweep in the kernel's compare form counts as the plain
    version's float32-compare form, bit for bit; the thresholds are the
    largest bf16 values not above T_MIN and DET_EPS, so a bf16 value
    exceeds a float32 threshold exactly when it exceeds that value."""
    o3, d3, tripack = bf16_probe.make_inputs(3000, 160, seed=11)
    f32_form = bf16_probe.hit_count_plain(o3, d3, tripack, "bf16")
    packed = _bf16_count_packed_compare(o3, d3, tripack)
    assert torch.equal(packed, f32_form)
    assert f32_form.sum() > 0
    for x in (bf16_probe.DET_EPS, bf16_probe.T_MIN):
        below = _below_bf16(x)
        up = (below.view(torch.int16) + 1).view(torch.bfloat16)
        assert float(below) <= x < float(up)


def _c_parameters(source: str, entry: str) -> list[str]:
    with open(os.path.join(build.CSRC_DIR, source)) as f:
        text = f.read()
    head = text.index(f'extern "C" int {entry}(')
    body = text[text.index("(", head) + 1:text.index(")", head)]
    return [" ".join(p.split()) for p in body.split(",")]


@pytest.mark.parametrize("source,entry,argtypes", [
    ("probe_plucker.cu", "ptt_probe_plucker", mma_probe._ARGTYPES),
    ("probe_bf16.cu", "ptt_probe_bf16", bf16_probe._ARGTYPES),
])
def test_probe_entries_match_their_argtypes(source, entry, argtypes):
    params = _c_parameters(source, entry)
    assert len(params) == len(argtypes), params
    for decl, argtype in zip(params, argtypes):
        want = ctypes.c_void_p if "*" in decl else ctypes.c_int
        assert argtype is want, (decl, argtype)
