// K9: walker any-hit: shadow-ray occlusion over each ray block's
// front-to-back candidate clusters.
//
// Replaces the TPU kernel pathtracerpython_tpu/kernels/walker_pallas.py
// _any_hit_chunk (the pallas_call over _make_walker_kernel(any_hit=True)).
//
// Input: blocks of r_blk shadow rays, each with its maximum distance maxd,
// and per block the clusters any of its rays can touch within the block's
// largest maxd, sorted by a conservative block-level entry bound (the
// walker lists of kernels/walker.py). The lists are complete: no overflow.
//
// Design: K6's function on the walker's lists, and K6's walk: the split
// any-hit walk with the in-cluster box cull (any_hit_walk.cuh). The TPU
// kernel walks one list per 1280-ray block and stops the whole block's walk
// in 19-bit key words once no unoccluded ray's window reaches the next
// cluster; here a list is walked in units of kAnyHitSegment slots on many
// CTAs, each with that stop compared in floats, merged per lane by its
// occlusion mark (occ, zeroed before the launch), and a visited cluster's
// rows are culled by span, mid and group boxes.
//
// What bounds it on an H100: as K6 (sparse_any_hit.cu); the walker's blocks
// of 1280 rays share one list over five CTAs a unit.
#include <cuda_runtime.h>

#include "any_hit_walk.cuh"
#include "cluster.cuh"
#include "mt.cuh"

namespace {

template <bool kCount>
__global__ void __launch_bounds__(ptt::kThreads)
walker_any_hit_kernel(const float* __restrict__ o3,
                      const float* __restrict__ d3,
                      const float* __restrict__ maxd, int n,
                      const float* __restrict__ tripack,
                      const float* __restrict__ aabb8,
                      const float* __restrict__ cull,
                      const int* __restrict__ ids,
                      const float* __restrict__ keys,
                      const int* __restrict__ ncand, int n_cols, int r_blk,
                      unsigned char* occ,
                      unsigned long long* __restrict__ stats) {
  __shared__ ptt::AnyHitStage<ptt::ClassicForm> stage;
  ptt::split_any_hit<ptt::ClassicForm, kCount>(
      stage, o3, d3, maxd, n, tripack, aabb8, cull, ids, keys, ncand, n_cols,
      r_blk, occ, stats);
}

}  // namespace

// o3, d3: float32 [3, n] (d3 unit length); maxd: float32 [n];
// tripack: float32 [C * 128, 12]; aabb8: float32 [C, 8]; cull: float32
// [C, 84, 8], each cluster's span, mid and group boxes (kernels/sparse.py:
// cluster_cull_boxes; null is refused); ids: int32 [ceil(n / r_blk),
// n_cols] and keys: float32 [ceil(n / r_blk), n_cols], row b holding block
// b's clusters and their entry bounds front to back; ncand: int32
// [ceil(n / r_blk)]; occ: bool (one byte) [n], zeroed by the caller; stats:
// null, or seven 64-bit counters (cluster.cuh: WalkCounter, then
// any_hit_walk.cuh: AnyHitCounter) that the launch adds to. Launches on
// ``stream`` of CUDA device ``device`` and returns cudaGetLastError() as an
// int (0 = launched).
extern "C" int ptt_walker_any_hit(const float* o3, const float* d3,
                                  const float* maxd, int n,
                                  const float* tripack, const float* aabb8,
                                  const float* cull, const int* ids,
                                  const float* keys, const int* ncand,
                                  int n_cols, int r_blk, unsigned char* occ,
                                  unsigned long long* stats, int device,
                                  void* stream) {
  if (n <= 0 || n_cols < 1 || r_blk < 1 || cull == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid = ptt::walk_grid(n, r_blk, n_cols, ptt::kAnyHitSegment);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stats == nullptr)
    walker_any_hit_kernel<false><<<grid, ptt::kThreads, 0, st>>>(
        o3, d3, maxd, n, tripack, aabb8, cull, ids, keys, ncand, n_cols,
        r_blk, occ, stats);
  else
    walker_any_hit_kernel<true><<<grid, ptt::kThreads, 0, st>>>(
        o3, d3, maxd, n, tripack, aabb8, cull, ids, keys, ncand, n_cols,
        r_blk, occ, stats);
  return static_cast<int>(cudaGetLastError());
}
