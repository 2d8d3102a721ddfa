// Möller–Trumbore ray-triangle test and the shared-memory triangle tile,
// shared by every kernel of the library.
//
// The arithmetic follows pathtracerpython_tpu/kernels/intersect_pallas.py
// _mt_rows term for term: e1 = v1 - v0 and e2 = v2 - v0 formed from the
// packed vertices, every dot product written a*b + c*d + e*f and summed
// left to right, inv_det = 1 / det. The library is compiled with
// -fmad=false, so no product is fused into an add and the kernels give the
// same bits as their plain PyTorch versions (kernels/intersect.py).
#pragma once

#include <cuda_runtime.h>

namespace ptt {

constexpr float kDetEps = 1e-7f;  // |det| > kDetEps: not parallel
constexpr float kTMin = 1e-4f;    // forward near-clip
constexpr float kBig = 3.0e38f;   // "no hit yet"
constexpr int kPackCols = 12;     // v0.xyz | v1.xyz | v2.xyz | valid | occluder | 0
constexpr int kValidCol = 9;
constexpr int kOccluderCol = 10;
constexpr int kTile = 256;        // triangles staged in shared memory at a time
constexpr int kThreads = 256;     // rays (one per thread) per block

// A tile of triangles in shared memory, structure of arrays: every thread
// of the block reads the same row at the same time, a broadcast.
struct TriTile {
  float v0x[kTile], v0y[kTile], v0z[kTile];
  float e1x[kTile], e1y[kTile], e1z[kTile];
  float e2x[kTile], e2y[kTile], e2z[kTile];
  unsigned char use[kTile];  // row takes part in this sweep
};

// Cooperative load of rows [base, base + rows) of the [T, 12] pack.
// ``mask_col`` names the pack column that must be > 0.5 besides valid
// (column 9): -1 for the nearest sweep, 10 (occluder) for shadow rays.
__device__ __forceinline__ void load_tile(TriTile& tile,
                                          const float* __restrict__ pack,
                                          int base, int rows, int mask_col) {
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const float* p = pack + static_cast<size_t>(base + r) * kPackCols;
    const float v0x = p[0], v0y = p[1], v0z = p[2];
    tile.v0x[r] = v0x;
    tile.v0y[r] = v0y;
    tile.v0z[r] = v0z;
    tile.e1x[r] = p[3] - v0x;
    tile.e1y[r] = p[4] - v0y;
    tile.e1z[r] = p[5] - v0z;
    tile.e2x[r] = p[6] - v0x;
    tile.e2y[r] = p[7] - v0y;
    tile.e2z[r] = p[8] - v0z;
    tile.use[r] = p[kValidCol] > 0.5f && (mask_col < 0 || p[mask_col] > 0.5f);
  }
}

// Forward hit of ray (o, d) against the triangle (v0, e1, e2); writes t
// either way.
__device__ __forceinline__ bool mt_core(float v0x, float v0y, float v0z,
                                        float e1x, float e1y, float e1z,
                                        float e2x, float e2y, float e2z,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float& t_out) {
  // pvec = d x e2
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool not_par = fabsf(det) > kDetEps;
  const float inv_det = 1.0f / (not_par ? det : 1.0f);
  const float tvx = ox - v0x;
  const float tvy = oy - v0y;
  const float tvz = oz - v0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  // qvec = tvec x e1
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  t_out = t;
  return not_par && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > kTMin;
}

// Forward hit of ray (o, d) against tile row j; writes t either way.
__device__ __forceinline__ bool mt_hit(const TriTile& tile, int j,
                                       float ox, float oy, float oz,
                                       float dx, float dy, float dz,
                                       float& t_out) {
  return mt_core(tile.v0x[j], tile.v0y[j], tile.v0z[j], tile.e1x[j],
                 tile.e1y[j], tile.e1z[j], tile.e2x[j], tile.e2y[j],
                 tile.e2z[j], ox, oy, oz, dx, dy, dz, t_out);
}

// Forward hit of ray (o, d) against one packed row p[0:12], with e1 and e2
// formed here exactly as load_tile forms them.
__device__ __forceinline__ bool mt_hit_row(const float* p, float ox,
                                           float oy, float oz, float dx,
                                           float dy, float dz, float& t_out) {
  const float v0x = p[0], v0y = p[1], v0z = p[2];
  return mt_core(v0x, v0y, v0z, p[3] - v0x, p[4] - v0y, p[5] - v0z,
                 p[6] - v0x, p[7] - v0y, p[8] - v0z, ox, oy, oz, dx, dy, dz,
                 t_out);
}

// The classic form as the sweeps' template parameter (nearest.cu,
// any_hit.cu, sparse_nearest.cu, sparse_any_hit.cu); PluckerForm
// (plucker.cuh) is the other. A form names its pack layout, its
// shared-memory tile, what it keeps per ray, and the pair test against a
// tile row or a staged packed row.
struct ClassicForm {
  using Tile = TriTile;
  struct Ray {
    float ox, oy, oz, dx, dy, dz;
  };
  static constexpr int kCols = kPackCols;
  static constexpr int kValid = kValidCol;
  static constexpr int kOccluder = kOccluderCol;

  static __device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                                 float dx, float dy,
                                                 float dz) {
    return Ray{ox, oy, oz, dx, dy, dz};
  }
  static __device__ __forceinline__ void load(Tile& tile,
                                              const float* __restrict__ pack,
                                              int base, int rows,
                                              int mask_col) {
    load_tile(tile, pack, base, rows, mask_col);
  }
  static __device__ __forceinline__ bool use(const Tile& tile, int j) {
    return tile.use[j];
  }
  static __device__ __forceinline__ bool hit(const Tile& tile, int j,
                                             const Ray& r, float& t_out) {
    return mt_hit(tile, j, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, t_out);
  }
  static __device__ __forceinline__ bool hit_row(const float* p, const Ray& r,
                                                 float& t_out) {
    return mt_hit_row(p, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, t_out);
  }
};

}  // namespace ptt
