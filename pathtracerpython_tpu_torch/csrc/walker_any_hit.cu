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
// Design: one CTA of 256 threads owns a slice of one block, one ray per
// thread; the clusters' packed rows are double-buffered in shared memory
// with cp.async, as in K5. A ray is occluded by a valid occluder triangle
// (pack column 10) with a forward hit at t < maxd - 1e-4; a thread stops
// testing once its ray is occluded. The CTA stops the whole walk once no
// unoccluded ray's window reaches the next cluster's bound (bound > maxd +
// SLAB_EPS for every such ray), which covers "every ray occluded" too: the
// bounds only grow along the list and a ray's own entry is never below its
// block's bound (cluster.cuh), so no later cluster can occlude. This is
// walker_pallas.py's whole-walk stop, compared in floats instead of 19-bit
// keys. Per cluster, each unoccluded thread runs its own slab test and,
// when the box is hit with entry < maxd + SLAB_EPS, Möller–Trumbore
// (mt.cuh) over the 128 rows until its first blocking hit. Parked rays
// (maxd = 0) can never be occluded and never ask for a cluster.
//
// What bounds it on an H100: arithmetic on the visited clusters, and the
// length of the walk; most shadow rays of a large scene are occluded
// within a few clusters, and the whole-walk stop ends their CTAs there.
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "mt.cuh"

namespace {

__global__ void __launch_bounds__(ptt::kThreads)
walker_any_hit_kernel(const float* __restrict__ o3,
                      const float* __restrict__ d3,
                      const float* __restrict__ maxd, int n,
                      const float* __restrict__ tripack,
                      const float* __restrict__ aabb8, int n_clusters,
                      const int* __restrict__ ids,
                      const float* __restrict__ keys,
                      const int* __restrict__ ncand, int r_blk,
                      unsigned char* __restrict__ occ_out) {
  __shared__ __align__(16) float buf[2][ptt::kClusterFloats];
  const ptt::BlockSlice me = ptt::block_slice(r_blk, n);
  const size_t stride = static_cast<size_t>(n);
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float md = 0.f;
  if (me.live) {
    ox = o3[me.lane];
    oy = o3[stride + me.lane];
    oz = o3[2 * stride + me.lane];
    dx = d3[me.lane];
    dy = d3[stride + me.lane];
    dz = d3[2 * stride + me.lane];
    md = maxd[me.lane];
  }
  const ptt::SlabRay ray = ptt::make_slab_ray(ox, oy, oz, dx, dy, dz);
  // t > T_MIN and t < md - T_MIN cannot both hold unless md - T_MIN > T_MIN
  const float t_cut = md - ptt::kTMin;
  bool open = me.live && t_cut > ptt::kTMin;  // not occluded, can still be

  const int count = ncand[me.block];
  const size_t row = static_cast<size_t>(me.block) * n_clusters;
  if (count > 0) ptt::stage_cluster(buf[0], tripack, ids[row]);
  int cur = 0;
  for (int s = 0; s < count; ++s) {
    const int cl = ids[row + s];
    ptt::wait_staged();
    // whole-walk stop; the barrier also completes buf[cur] and frees
    // buf[cur ^ 1], read in the previous step
    if (!__syncthreads_or(open && keys[row + s] <= md + ptt::kSlabEps)) break;
    if (s + 1 < count)
      ptt::stage_cluster(buf[cur ^ 1], tripack, ids[row + s + 1]);
    float enter;
    if (open && ptt::slab_hit(aabb8 + cl * ptt::kAabbCols, ray, enter) &&
        enter < md + ptt::kSlabEps) {
      const float* tile = buf[cur];
      for (int j = 0; j < ptt::kClusterTris; ++j) {
        const float* p = tile + j * ptt::kPackCols;
        float t;
        if (p[ptt::kValidCol] > 0.5f && p[ptt::kOccluderCol] > 0.5f &&
            ptt::mt_hit_row(p, ox, oy, oz, dx, dy, dz, t) && t < t_cut) {
          open = false;
          break;
        }
      }
    }
    cur ^= 1;
  }
  ptt::wait_staged();  // no copy left in flight
  if (me.live) occ_out[me.lane] = !open && t_cut > ptt::kTMin;
}

}  // namespace

// o3, d3: float32 [3, n] (d3 unit length); maxd: float32 [n];
// tripack: float32 [C * 128, 12]; aabb8: float32 [C, 8]; ids: int32
// [ceil(n / r_blk), C] and keys: float32 [ceil(n / r_blk), C], row b holding
// block b's clusters and their entry bounds front to back; ncand: int32
// [ceil(n / r_blk)]; occ_out: bool (one byte) [n]. Launches on ``stream`` of
// CUDA device ``device`` and returns cudaGetLastError() as an int.
extern "C" int ptt_walker_any_hit(const float* o3, const float* d3,
                                  const float* maxd, int n,
                                  const float* tripack, const float* aabb8,
                                  int n_clusters, const int* ids,
                                  const float* keys, const int* ncand,
                                  int r_blk, unsigned char* occ_out,
                                  int device, void* stream) {
  if (n <= 0 || n_clusters < 1 || r_blk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  walker_any_hit_kernel<<<ptt::slice_ctas(n, r_blk), ptt::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      o3, d3, maxd, n, tripack, aabb8, n_clusters, ids, keys, ncand, r_blk,
      occ_out);
  return static_cast<int>(cudaGetLastError());
}
