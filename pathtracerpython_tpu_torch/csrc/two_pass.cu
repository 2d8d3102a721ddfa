// The finality test of the two-pass protocol of the uncached cluster sweeps
// (kernels/sparse.py: K5, K6 and K3's sparse sweeps over truncated lists),
// one thread a lane, fused into one pass: the lane's lower bound ne on the
// entry of every cluster its block's truncated list dropped, and whether
// the lane is unfinished, so that pass 2 must sweep it again with the full
// list.
//
// Replaces no TPU kernel: the JAX package computes the same in plain XLA
// (pathtracerpython_tpu/kernels/sparse_pallas.py _lane_unseen_bound, :430,
// over _lane_slab_enter_exit, :406, and the finality tests of
// _sparse_nearest_entry, :1993, and sparse_any_hit_cm, :2124). Its plain
// twin is kernels/sparse.py: two_pass_flags_plain, which gives the same
// flags bit for bit.
//
// ne: the lane's own slab entry (clamped to >= 0) into each of the first
// lane_m dropped clusters that it hits (a miss bounds nothing), and beyond
// those the block key ``far`` of the next dropped candidate (kBig when
// nothing more was dropped); the front-to-back order makes the block keys
// monotone, and a block key bounds every lane's entry from below.
//
// Unfinished, nearest: ne < t1 + SLAB_EPS, t1 the lane's pass-1 best read
// from K5's merged 64-bit word (kBig where no unit published a hit). Any-
// hit: not occluded in pass 1, able to be blocked at all (maxd - T_MIN >
// T_MIN, as the any-hit walks' gate), and ne < maxd + SLAB_EPS. Both also
// ask that the lane's ray meet the box of the whole scene (the union of the
// clusters' boxes): a ray that misses it misses every cluster, and the
// slab test is monotone in the box, so such a lane (a parked one, or one
// that leaves the scene) is final whatever ``far`` says. The JAX package's
// test lacks this last condition; it changes no result, only which lanes
// reach pass 2.
//
// Arithmetic: cluster.cuh's slab test, the reciprocal by IEEE division
// (no fast math; built with -fmad=false), min and max exact, so ne and the
// flags round as the plain twin's.
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "mt.cuh"

namespace {

// What the nearest sweep's pass 1 left a lane: its best t, and whether it
// can still change.
struct NearestReach {
  const unsigned long long* __restrict__ words;
  __device__ __forceinline__ bool open(int lane, float& reach) const {
    const unsigned long long w = words[lane];
    reach = w == ptt::kNoHitWord ? ptt::kBig : ptt::word_t(w);
    return true;
  }
};

// What the any-hit's pass 1 left a lane: its shadow window, and whether it
// is still open (not blocked, and a blocking hit is possible at all).
struct AnyHitReach {
  const unsigned char* __restrict__ occ;
  const float* __restrict__ maxd;
  __device__ __forceinline__ bool open(int lane, float& reach) const {
    reach = maxd[lane];
    return occ[lane] == 0 && reach - ptt::kTMin > ptt::kTMin;
  }
};

template <class Reach>
__global__ void __launch_bounds__(ptt::kThreads)
select_kernel(const float* __restrict__ o3, const float* __restrict__ d3,
              int n, Reach reach_of, const float* __restrict__ aabb8,
              const float* __restrict__ scene_box,
              const int* __restrict__ drop_ids,
              const float* __restrict__ drop_keys,
              const float* __restrict__ far, int lane_m, int r_blk,
              unsigned char* __restrict__ flags, float* __restrict__ ne_out) {
  const int lane = blockIdx.x * ptt::kThreads + threadIdx.x;
  if (lane >= n) return;
  const size_t stride = static_cast<size_t>(n);
  const ptt::SlabRay ray = ptt::make_slab_ray(
      o3[lane], o3[stride + lane], o3[2 * stride + lane], d3[lane],
      d3[stride + lane], d3[2 * stride + lane]);
  const int block = lane / r_blk;
  float ne = far[block];
  const size_t row = static_cast<size_t>(block) * lane_m;
  for (int j = 0; j < lane_m; ++j) {
    // a slot names a dropped candidate iff its block key is finite
    if (!(drop_keys[row + j] < ptt::kBig)) continue;
    float enter0;
    if (ptt::slab_hit(aabb8 + drop_ids[row + j] * ptt::kAabbCols, ray,
                      enter0))
      ne = fminf(ne, enter0);
  }
  float reach;
  const bool open = reach_of.open(lane, reach);
  float scene_enter;
  const bool meets = ptt::slab_hit(scene_box, ray, scene_enter);
  flags[lane] = open && meets && ne < reach + ptt::kSlabEps;
  if (ne_out != nullptr) ne_out[lane] = ne;
}

template <class Reach>
int launch_select(const float* o3, const float* d3, int n, Reach reach,
                  const float* aabb8, const float* scene_box,
                  const int* drop_ids, const float* drop_keys,
                  const float* far, int lane_m, int r_blk,
                  unsigned char* flags, float* ne_out, int device,
                  void* stream) {
  if (n <= 0 || lane_m < 0 || r_blk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  select_kernel<Reach>
      <<<(n + ptt::kThreads - 1) / ptt::kThreads, ptt::kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          o3, d3, n, reach, aabb8, scene_box, drop_ids, drop_keys, far,
          lane_m, r_blk, flags, ne_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o3, d3: float32 [3, n] (d3 unit length); words: uint64 [n], K5's (or K3's
// sparse nearest's) merged words of pass 1; aabb8: float32 [C, 8];
// scene_box: float32 [8], min.xyz | max.xyz of every cluster box;
// drop_ids: int32 [ceil(n / r_blk), lane_m] and drop_keys: float32
// [ceil(n / r_blk), lane_m], each block's first lane_m dropped list slots
// (a key of kBig or more: no candidate); far: float32 [ceil(n / r_blk)];
// flags: bool (one byte) [n]; ne_out: float32 [n], or null. Launches on
// ``stream`` of CUDA device ``device`` and returns cudaGetLastError() as an
// int (0 = launched).
extern "C" int ptt_two_pass_nearest_select(
    const float* o3, const float* d3, int n, const unsigned long long* words,
    const float* aabb8, const float* scene_box, const int* drop_ids,
    const float* drop_keys, const float* far, int lane_m, int r_blk,
    unsigned char* flags, float* ne_out, int device, void* stream) {
  if (words == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_select(o3, d3, n, NearestReach{words}, aabb8, scene_box,
                       drop_ids, drop_keys, far, lane_m, r_blk, flags,
                       ne_out, device, stream);
}

// The same for the any-hit: occ: bool (one byte) [n], K6's (or K3's sparse
// any-hit's) marks of pass 1; maxd: float32 [n].
extern "C" int ptt_two_pass_any_hit_select(
    const float* o3, const float* d3, int n, const unsigned char* occ,
    const float* maxd, const float* aabb8, const float* scene_box,
    const int* drop_ids, const float* drop_keys, const float* far,
    int lane_m, int r_blk, unsigned char* flags, float* ne_out, int device,
    void* stream) {
  if (occ == nullptr || maxd == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_select(o3, d3, n, AnyHitReach{occ, maxd}, aabb8, scene_box,
                       drop_ids, drop_keys, far, lane_m, r_blk, flags,
                       ne_out, device, stream);
}
