// K3: the Plücker form of the ray-triangle test, shared by the four sweeps
// that follow the MT_IMPL knob (nearest.cu, any_hit.cu, sparse_nearest.cu,
// sparse_any_hit.cu) and by the probe (probe_plucker.cu).
//
// Replaces pathtracerpython_tpu/kernels/intersect_pallas.py _plucker_block
// (with _plucker_packs on the PyTorch side, kernels/intersect.py:
// plucker_pack). A ray is inside a triangle when its three edge side
// products
//     side_e = dir_e . (o x d) + moment_e . d,   moment_e = a x b,
// all have one sign (all >= 0 or all <= 0); t comes from the triangle's
// plane, t = n . (v0 - o) / (n . d) with n = e1 x e2 unnormalized, so the
// parallel test |n . d| > 1e-7 is the classic form's |det| test. Pad and
// degenerate rows have all-zero sides and so count as inside: the parallel
// test and the valid column are what rejects them.
//
// The TPU kernel computes each side as a [T, 8] x [8, R] matrix product,
// because its matrix unit is idle in the classic sweep. Here the side
// products are float32 multiplies and adds on the CUDA cores, six products
// summed left to right, which is the order of the plain version
// (kernels/intersect.py: plucker_rows), and the library is compiled with
// -fmad=false, so kernel and plain version give the same bits. The tensor
// cores are not used: a TF32 mma keeps 10 mantissa bits of each operand,
// and a side product is a difference of large moment terms whose sign
// decides the hit, so one TF32 pass flips winners well away from grazing
// rays. csrc/probe_plucker.cu measures exactly that, and what the 3xTF32
// split costs.
//
// A packed row is 36 floats (144 bytes, 16-byte aligned), read as float4:
//   0-7   edge v0v1: dir.xyz | moment.xyz | 0 0
//   8-15  edge v1v2, 16-23 edge v2v0: the same
//   24-35 n.xyz | v0.xyz | valid | occluder | 0 0 0 0
// About 47 float operations a pair (3 x 11 sides, 5 for n . d, 8 for the
// numerator, 1 division) against the classic form's 46; the ray's moment
// o x d (9 more) is formed once per ray, not per pair.
#pragma once

#include <cuda_runtime.h>

#include "mt.cuh"

namespace ptt {

constexpr int kPluckerCols = 36;
constexpr int kPluckerValidCol = 30;
constexpr int kPluckerOccluderCol = 31;

// A tile of packed Plücker rows in shared memory, rows as they are in the
// pack: every thread of the block reads the same row at the same time, a
// broadcast of eight 16-byte loads.
struct PluckerTile {
  __align__(16) float rows[kTile * kPluckerCols];
  unsigned char use[kTile];  // row takes part in this sweep
};

// side = dir . m + moment . d, from a = (dir.xyz, moment.x) and
// b = (moment.y, moment.z, 0, 0)
__device__ __forceinline__ float plucker_side(const float4 a, const float4 b,
                                              float mx, float my, float mz,
                                              float dx, float dy, float dz) {
  return a.x * mx + a.y * my + a.z * mz + a.w * dx + b.x * dy + b.y * dz;
}

// The plane's t and the parallel test from q6 = (n.xyz, v0.x) and
// q7 = (v0.y, v0.z, valid, occluder); writes t either way.
__device__ __forceinline__ bool plucker_plane(const float4 q6, const float4 q7,
                                              float ox, float oy, float oz,
                                              float dx, float dy, float dz,
                                              float& t_out) {
  const float nd = q6.x * dx + q6.y * dy + q6.z * dz;
  const bool not_par = fabsf(nd) > kDetEps;
  const float t =
      (q6.x * (q6.w - ox) + q6.y * (q7.x - oy) + q6.z * (q7.y - oz)) /
      (not_par ? nd : 1.0f);
  t_out = t;
  return not_par && t > kTMin;
}

__device__ __forceinline__ bool plucker_inside(float s0, float s1, float s2) {
  return (s0 >= 0.0f && s1 >= 0.0f && s2 >= 0.0f) ||
         (s0 <= 0.0f && s1 <= 0.0f && s2 <= 0.0f);
}

struct PluckerForm {
  using Tile = PluckerTile;
  struct Ray {
    float ox, oy, oz, dx, dy, dz, mx, my, mz;  // m = o x d
  };
  static constexpr int kCols = kPluckerCols;
  static constexpr int kValid = kPluckerValidCol;
  static constexpr int kOccluder = kPluckerOccluderCol;

  static __device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                                 float dx, float dy,
                                                 float dz) {
    return Ray{ox,
               oy,
               oz,
               dx,
               dy,
               dz,
               oy * dz - oz * dy,
               oz * dx - ox * dz,
               ox * dy - oy * dx};
  }

  // Cooperative copy of rows [base, base + rows) of the [T, 36] pack,
  // 16 bytes a thread at a time. ``mask_col``: the pack column that must be
  // > 0.5 besides valid: -1 for the nearest sweep, 31 (occluder) for
  // shadow rays.
  static __device__ __forceinline__ void load(Tile& tile,
                                              const float* __restrict__ pack,
                                              int base, int rows,
                                              int mask_col) {
    const float4* src = reinterpret_cast<const float4*>(
        pack + static_cast<size_t>(base) * kPluckerCols);
    float4* dst = reinterpret_cast<float4*>(tile.rows);
    for (int k = threadIdx.x; k < rows * (kPluckerCols / 4); k += blockDim.x)
      dst[k] = src[k];
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const float* p = pack + static_cast<size_t>(base + r) * kPluckerCols;
      tile.use[r] = p[kPluckerValidCol] > 0.5f &&
                    (mask_col < 0 || p[mask_col] > 0.5f);
    }
  }
  static __device__ __forceinline__ bool use(const Tile& tile, int j) {
    return tile.use[j];
  }

  // Forward hit of the ray against one packed row p[0:36] (16-byte
  // aligned); the valid and occluder columns are the caller's to read.
  // Writes t either way.
  static __device__ __forceinline__ bool hit_row(const float* p, const Ray& r,
                                                 float& t_out) {
    const float4* q = reinterpret_cast<const float4*>(p);
    const float s0 =
        plucker_side(q[0], q[1], r.mx, r.my, r.mz, r.dx, r.dy, r.dz);
    const float s1 =
        plucker_side(q[2], q[3], r.mx, r.my, r.mz, r.dx, r.dy, r.dz);
    const float s2 =
        plucker_side(q[4], q[5], r.mx, r.my, r.mz, r.dx, r.dy, r.dz);
    const bool plane =
        plucker_plane(q[6], q[7], r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, t_out);
    return plucker_inside(s0, s1, s2) && plane;
  }
  static __device__ __forceinline__ bool hit(const Tile& tile, int j,
                                             const Ray& r, float& t_out) {
    return hit_row(tile.rows + j * kPluckerCols, r, t_out);
  }
};

}  // namespace ptt
