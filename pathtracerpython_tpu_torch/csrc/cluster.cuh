// Device code shared by the cluster walks: the sparse sweeps K5
// (sparse_nearest.cu), K6 (sparse_any_hit.cu) and K7
// (sparse_any_hit_idx.cu), and the walker sweeps K8 (walker_nearest.cu) and
// K9 (walker_any_hit.cu): the per-ray slab test against a cluster's AABB,
// the staging of a cluster's triangles into shared memory, and the mapping
// of a CTA onto a slice of one ray block.
//
// The slab arithmetic follows pathtracerpython_tpu/kernels/sparse_pallas.py
// _inv_rows / _slab_rows_inv term for term: the direction's reciprocal with
// |d| clamped to 1e-12 (sign kept), per-axis (box - o) * inv, the entry as
// the max of the per-axis near times and the exit as the min of the far
// times, and a hit when exit >= max(entry, 0) - SLAB_EPS. The entry that
// gates a cluster is clamped to >= 0.
//
// Why the whole-walk stop is exact: the lists are sorted by each block's
// interval entry bound (kernels/sparse.py: candidate_enter_hit), built from
// the same reciprocal on the block's origin and direction boxes. Float
// subtraction, reciprocal and product round monotonically, so a ray's own
// clamped entry to a cluster is never below its block's bound; once the
// bound exceeds what a ray can still use, no later cluster of the list is
// needed by that ray.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "mt.cuh"

namespace ptt {

constexpr int kClusterTris = 128;  // triangles per cluster (C_TRI)
constexpr int kClusterFloats = kClusterTris * kPackCols;  // 6 KB
constexpr int kAabbCols = 8;       // min.xyz | max.xyz | 0 | 0
constexpr float kSlabEps = 1e-3f;  // conservative slack of every slab test

// A ray's origin and the clamped reciprocal of its direction.
struct SlabRay {
  float ox, oy, oz, ix, iy, iz;
};

__device__ __forceinline__ float safe_inv(float d) {
  const float s = fabsf(d) < 1e-12f ? (d >= 0.0f ? 1e-12f : -1e-12f) : d;
  return 1.0f / s;
}

__device__ __forceinline__ SlabRay make_slab_ray(float ox, float oy, float oz,
                                                 float dx, float dy,
                                                 float dz) {
  return SlabRay{ox, oy, oz, safe_inv(dx), safe_inv(dy), safe_inv(dz)};
}

// Slab test of one ray against box[0:6] = min.xyz | max.xyz. Returns the
// hit and writes the entry clamped to >= 0.
__device__ __forceinline__ bool slab_hit(const float* __restrict__ box,
                                         const SlabRay& r, float& enter0) {
  const float o[3] = {r.ox, r.oy, r.oz};
  const float inv[3] = {r.ix, r.iy, r.iz};
  float enter = 0.0f, exit = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float lo = (box[k] - o[k]) * inv[k];
    const float hi = (box[k + 3] - o[k]) * inv[k];
    const float tn = fminf(lo, hi);
    const float tf = fmaxf(lo, hi);
    enter = k == 0 ? tn : fmaxf(enter, tn);
    exit = k == 0 ? tf : fminf(exit, tf);
  }
  enter0 = fmaxf(enter, 0.0f);
  return exit >= enter0 - kSlabEps;
}

// Starts the asynchronous copy (cp.async, 16 bytes a thread at a time) of
// cluster ``cl``'s 128 packed rows of ``Cols`` floats into ``dst``; every
// thread of the CTA takes part. The rows of a cluster are contiguous in the
// pack and 16-byte aligned (6144 bytes each cluster of the 12-column pack,
// 18432 of the 36-column Plücker pack; the pack from a PyTorch allocation).
template <int Cols = kPackCols>
__device__ __forceinline__ void stage_cluster(float* dst,
                                              const float* __restrict__ pack,
                                              int cl) {
  constexpr int kFloats = kClusterTris * Cols;
  static_assert(kFloats % 4 == 0, "a cluster is copied 16 bytes at a time");
  const float* src = pack + static_cast<size_t>(cl) * kFloats;
  for (int k = threadIdx.x; k < kFloats / 4; k += blockDim.x)
    __pipeline_memcpy_async(dst + 4 * k, src + 4 * k, 16);
  __pipeline_commit();
}

// Waits for this thread's staged copies; a barrier after it makes every
// thread's copies visible.
__device__ __forceinline__ void wait_staged() { __pipeline_wait_prior(0); }

// A CTA of kThreads threads owns one slice of one ray block of r_blk rays;
// ceil(r_blk / kThreads) CTAs cover a block. Lanes past the block's width
// or past n are not live.
struct BlockSlice {
  int block;  // ray block index
  int lane;   // this thread's global ray index
  bool live;
};

__device__ __forceinline__ BlockSlice block_slice(int r_blk, int n) {
  const int slices = (r_blk + kThreads - 1) / kThreads;
  const int block = blockIdx.x / slices;
  const int within = (blockIdx.x % slices) * kThreads + threadIdx.x;
  const int lane = block * r_blk + within;
  return BlockSlice{block, lane, within < r_blk && lane < n};
}

// CTAs that cover n rays in blocks of r_blk.
inline int slice_ctas(int n, int r_blk) {
  const int blocks = (n + r_blk - 1) / r_blk;
  return blocks * ((r_blk + kThreads - 1) / kThreads);
}

}  // namespace ptt
