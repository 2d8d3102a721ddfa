// K7: cluster-sparse shadow any-hit that also reports, per lane, the first
// blocking cluster in visit order: the producer of the occluder cache.
//
// Replaces the TPU kernel pathtracerpython_tpu/kernels/sparse_pallas.py
// _any_hit_idx_chunk (the pallas_call over
// _make_grouped_any_hit_idx_kernel).
//
// Input: as K6 (sparse_any_hit.cu), over one of two kinds of lists
// (kernels/sparse.py): pass 1 of the cache protocol gives each block its
// at most 8 most voted cached clusters in vote order with every bound 0
// (guess_lists); pass 2 gives the complete front-to-back lists
// (window_lists). Row b of ids/keys is n_cols wide, ncand[b] entries long.
//
// Design: the blocking predicate and the per-lane gate are K6's, and so is
// the grid: CTA (slice, y) takes the list slots y, y + kSlotLanes, ... of
// its block, the clusters' rows double-buffered in shared memory by
// cp.async. What differs is the second output. The TPU kernel runs a
// block's slots one after the other and writes the cluster at which a lane
// first became occluded. Whether slot s blocks a lane does not depend on
// the other slots, so that cluster is the smallest slot whose cluster
// passes the lane's gate and holds a blocking triangle. Parallel CTAs find
// it deterministically with atomicMin on the slot position into a scratch
// first_slot[n] (2^31 - 1 = none, set by the caller). A thread may skip
// slot s only when its lane already holds a smaller slot (K6 skips on any
// mark, which would let a later slot win here), and a CTA stops when that
// holds for every ray whose window still reaches the slot's bound. A
// second small kernel on the same stream then turns slots into outputs:
// occ = a slot was found, cl = ids[block, slot] or -1. The result is the
// same in every run, and equal to the plain walk's in list order.
//
// What bounds it on an H100: arithmetic on the visited clusters, as K6;
// pass 1 visits at most 8 clusters a block, one per CTA.
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "mt.cuh"

namespace {

constexpr int kSlotLanes = 8;          // CTAs that share one slice's list
constexpr int kNoSlot = 2147483647;    // first_slot of a lane not blocked

__global__ void __launch_bounds__(ptt::kThreads)
sparse_any_hit_idx_kernel(const float* __restrict__ o3,
                          const float* __restrict__ d3,
                          const float* __restrict__ maxd, int n,
                          const float* __restrict__ tripack,
                          const float* __restrict__ aabb8,
                          const int* __restrict__ ids,
                          const float* __restrict__ keys,
                          const int* __restrict__ ncand, int n_cols,
                          int r_blk, int* first_slot) {
  __shared__ __align__(16) float buf[2][ptt::kClusterFloats];
  const ptt::BlockSlice me = ptt::block_slice(r_blk, n);
  const int count = ncand[me.block];
  const int first = blockIdx.y;
  const int step = gridDim.y;
  if (first >= count) return;  // the same for every thread of the CTA

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
  const float t_cut = md - ptt::kTMin;
  const bool can = me.live && t_cut > ptt::kTMin;  // a blocker is possible
  int best = kNoSlot;  // the smallest blocking slot this thread knows of
  const volatile int* slots = first_slot;

  const size_t row = static_cast<size_t>(me.block) * n_cols;
  ptt::stage_cluster(buf[0], tripack, ids[row + first]);
  int cur = 0;
  for (int s = first; s < count; s += step) {
    const int cl = ids[row + s];
    ptt::wait_staged();
    if (can) best = min(best, slots[me.lane]);
    // a ray still has to test slot s (and maybe later ones) while it knows
    // of no earlier blocker and its window reaches the slot's bound; the
    // barrier also completes buf[cur] and frees buf[cur ^ 1]
    const bool wants = can && best > s && keys[row + s] <= md + ptt::kSlabEps;
    if (!__syncthreads_or(wants)) break;
    if (s + step < count)
      ptt::stage_cluster(buf[cur ^ 1], tripack, ids[row + s + step]);
    float enter;
    if (wants && ptt::slab_hit(aabb8 + cl * ptt::kAabbCols, ray, enter) &&
        enter < md + ptt::kSlabEps) {
      const float* tile = buf[cur];
      for (int j = 0; j < ptt::kClusterTris; ++j) {
        const float* p = tile + j * ptt::kPackCols;
        float t;
        if (p[ptt::kValidCol] > 0.5f && p[ptt::kOccluderCol] > 0.5f &&
            ptt::mt_hit_row(p, ox, oy, oz, dx, dy, dz, t) && t < t_cut) {
          atomicMin(first_slot + me.lane, s);
          best = s;
          break;
        }
      }
    }
    cur ^= 1;
  }
  ptt::wait_staged();  // no copy left in flight
}

// One thread per lane: the outputs from the lane's first blocking slot.
__global__ void __launch_bounds__(ptt::kThreads)
blocking_cluster_kernel(const int* __restrict__ first_slot, int n,
                        const int* __restrict__ ids, int n_cols, int r_blk,
                        unsigned char* __restrict__ occ_out,
                        int* __restrict__ cl_out) {
  const int lane = blockIdx.x * ptt::kThreads + threadIdx.x;
  if (lane >= n) return;
  const int slot = first_slot[lane];
  const bool blocked = slot != kNoSlot;
  occ_out[lane] = blocked;
  cl_out[lane] =
      blocked ? ids[static_cast<size_t>(lane / r_blk) * n_cols + slot] : -1;
}

}  // namespace

// o3, d3, maxd, tripack, aabb8, ids, keys, ncand, n_cols, r_blk: as
// ptt_sparse_any_hit. first_slot: int32 [n] scratch, every element 2^31 - 1
// on entry; occ_out: bool (one byte) [n]; cl_out: int32 [n], the first
// blocking cluster in list order, -1 where not occluded. Launches both
// kernels on ``stream`` of CUDA device ``device`` and returns
// cudaGetLastError() as an int (0 = launched).
extern "C" int ptt_sparse_any_hit_idx(const float* o3, const float* d3,
                                      const float* maxd, int n,
                                      const float* tripack,
                                      const float* aabb8, const int* ids,
                                      const float* keys, const int* ncand,
                                      int n_cols, int r_blk, int* first_slot,
                                      unsigned char* occ_out, int* cl_out,
                                      int device, void* stream) {
  if (n <= 0 || n_cols < 1 || r_blk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(ptt::slice_ctas(n, r_blk), kSlotLanes);
  sparse_any_hit_idx_kernel<<<grid, ptt::kThreads, 0, s>>>(
      o3, d3, maxd, n, tripack, aabb8, ids, keys, ncand, n_cols, r_blk,
      first_slot);
  const cudaError_t walked = cudaGetLastError();
  if (walked != cudaSuccess) return static_cast<int>(walked);
  blocking_cluster_kernel<<<(n + ptt::kThreads - 1) / ptt::kThreads,
                            ptt::kThreads, 0, s>>>(first_slot, n, ids, n_cols,
                                                   r_blk, occ_out, cl_out);
  return static_cast<int>(cudaGetLastError());
}
