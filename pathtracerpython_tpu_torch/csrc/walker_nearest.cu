// K8: walker nearest hit: each warp walks its ray block's front-to-back
// candidate clusters and stops on its own rays.
//
// Replaces the TPU kernel pathtracerpython_tpu/kernels/walker_pallas.py
// _nearest_chunk (the pallas_call over _make_walker_kernel(any_hit=False)).
//
// Input: blocks of r_blk rays, and per block the clusters (128 triangles
// each) any of its rays can touch, sorted by a conservative block-level
// entry bound (kernels/walker.py: nearest_lists). Row b of ids/keys (n_cols
// wide) holds block b's list, ncand[b] entries long; the lists are
// complete, so there is no overflow and no fallback.
//
// Design: what it computes is K5's function (sparse_nearest.cu) on the
// walker's lists: the lexicographic (t, global index) minimum, ties to the
// smaller index, t = 0 and index -1 on a miss. The TPU kernel walks one
// list per 1280-ray block, every lane paying for every visited cluster,
// and stops the whole block's walk in 19-bit key words. Here the list is
// walked by the split walk of cluster.cuh: a unit is one CTA over a slice
// of the block and one segment of kSegment slots of its list, so a list of
// 782 clusters is walked by 49 units at once. Inside a unit each warp of
// 32 consecutive (sorted, hence coherent) rays walks the segment by itself:
// no shared memory, no barrier, and the stop is per warp, on the largest
// bound t of its own 32 rays, compared in floats (exact, see cluster.cuh),
// so a warp that has found its hits leaves the segment long before the
// block's least coherent rays do. A ray's bound is its own best and the
// best any unit has merged into its scratch word, read once per slot; a
// better best is merged by a 64-bit atomicMin on (t bits, index), and a
// small second kernel writes t and index from the words. Per slot each ray
// runs its own slab test; the rays that need the cluster (box hit, entry <
// bound t + SLAB_EPS) read its 128 packed rows straight from global memory,
// 48 bytes a row as three 16-byte loads at an address the whole warp shares
// (one broadcast transaction, served by L1 and L2: neighbouring warps walk
// the same list), and run Möller–Trumbore (mt.cuh) on them.
//
// Why the winner is the serial walk's, and the dense K1's (cluster.cuh
// gives it in full): the word order is the lexicographic (t, index) order
// that the serial walk's strict t <, ties to the smaller index, realises,
// and a minimum does not depend on the order of the atomics; every bound a
// warp reads is a real hit or "none", never below the winner w, so the gate
// and the stop never drop w's cluster in the unit that owns its slot.
//
// What bounds it on an H100: arithmetic on the visited clusters plus the
// row loads, which no shared-memory staging amortizes over a CTA here.
// Before the split the few blocks whose lists span the scene (an octant
// edge or the parked tail, with a lane that misses and so never lets its
// warp stop) set the time, one SM walking 782 slots; now the longest walk
// is kSegment slots, at the price of bounds that a concurrent unit has not
// merged yet. A second instance counts units launched, units in which no
// warp passed its first slot, and (ray, cluster) visits through the gate.
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "mt.cuh"

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;

template <bool kCount>
__global__ void __launch_bounds__(ptt::kThreads)
walker_nearest_kernel(const float* __restrict__ o3,
                      const float* __restrict__ d3, int n,
                      const float* __restrict__ tripack,
                      const float* __restrict__ aabb8,
                      const int* __restrict__ ids,
                      const float* __restrict__ keys,
                      const int* __restrict__ ncand, int n_cols, int r_blk,
                      unsigned long long* words,
                      unsigned long long* __restrict__ stats) {
  // every thread of a CTA, hence of a warp, is in the same ray block
  const ptt::WalkUnit unit = ptt::walk_unit(r_blk, n, ncand);
  if (unit.first >= unit.count) return;  // the same for every thread
  const ptt::BlockSlice& me = unit.me;
  const size_t stride = static_cast<size_t>(n);
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (me.live) {
    ox = o3[me.lane];
    oy = o3[stride + me.lane];
    oz = o3[2 * stride + me.lane];
    dx = d3[me.lane];
    dy = d3[stride + me.lane];
    dz = d3[2 * stride + me.lane];
  }
  const ptt::SlabRay ray = ptt::make_slab_ray(ox, oy, oz, dx, dy, dz);
  const bool reads = me.live && unit.shared;  // other units merge into it
  unsigned long long best = ptt::start_word();
  // the word as read for the next slot, read one slot ahead
  unsigned long long seen =
      reads ? ptt::read_word(words, me.lane) : ptt::kNoHitWord;
  unsigned long long visits = 0;
  bool walked = false;  // the warp passed its stop at least once

  const size_t row = static_cast<size_t>(me.block) * n_cols;
  const float4* pack4 = reinterpret_cast<const float4*>(tripack);
  for (int s = unit.first; s < unit.end; ++s) {
    best = ptt::word_min(best, seen);
    const float bound = ptt::word_t(best);
    // the warp's stop: no ray of it can use this or any later cluster
    if (!__any_sync(kFullWarp,
                    me.live && keys[row + s] <= bound + ptt::kSlabEps))
      break;
    walked = true;
    if (reads) seen = ptt::read_word(words, me.lane);
    const int cl = ids[row + s];
    float enter;
    if (me.live && ptt::slab_hit(aabb8 + cl * ptt::kAabbCols, ray, enter) &&
        enter < bound + ptt::kSlabEps) {
      if (kCount) ++visits;
      const int base = cl * ptt::kClusterTris;
      const float4* rows = pack4 + static_cast<size_t>(base) * 3;
      const unsigned long long before = best;
      for (int j = 0; j < ptt::kClusterTris; ++j) {
        // v0.xyz v1.x | v1.yz v2.xy | v2.z valid occluder 0
        const float4 a = __ldg(rows + 3 * j);
        const float4 b = __ldg(rows + 3 * j + 1);
        const float4 c = __ldg(rows + 3 * j + 2);
        float t;
        if (c.y > 0.5f &&
            ptt::mt_core(a.x, a.y, a.z, a.w - a.x, b.x - a.y, b.y - a.z,
                         b.z - a.x, b.w - a.y, c.x - a.z, ox, oy, oz, dx, dy,
                         dz, t))
          best = ptt::word_min(best, ptt::hit_word(t, base + j));
      }
      if (best < before) ptt::publish_word(words, me.lane, best);
    }
  }
  if (kCount) {
    const bool any_walked = __syncthreads_or(walked);
    if (threadIdx.x == 0) {
      atomicAdd(stats + ptt::kUnitsLaunched, 1ull);
      if (!any_walked) atomicAdd(stats + ptt::kUnitsStoppedAtOnce, 1ull);
    }
    ptt::add_warp_count(stats + ptt::kVisits, visits);
  }
}

__global__ void __launch_bounds__(ptt::kThreads)
finish_kernel(const unsigned long long* __restrict__ words, int n,
              float* __restrict__ t_out, int* __restrict__ idx_out) {
  const int lane = blockIdx.x * ptt::kThreads + threadIdx.x;
  if (lane < n) ptt::finish_lane(words, lane, t_out, idx_out);
}

}  // namespace

// o3, d3: float32 [3, n] (d3 unit length); tripack: float32 [C * 128, 12],
// 16-byte aligned; aabb8: float32 [C, 8]; ids: int32 [ceil(n / r_blk),
// n_cols] and keys: float32 [ceil(n / r_blk), n_cols], row b holding block
// b's clusters and their entry bounds front to back; ncand: int32
// [ceil(n / r_blk)]; words: uint64 [n] scratch, every bit set on entry
// (null is refused); t_out: float32 [n]; idx_out: int32 [n]; stats: null,
// or three 64-bit counters (cluster.cuh: WalkCounter) that the launch adds
// to. Launches the walk and the kernel that writes the outputs on
// ``stream`` of CUDA device ``device`` and returns cudaGetLastError() as an
// int (0 = launched).
extern "C" int ptt_walker_nearest(const float* o3, const float* d3, int n,
                                  const float* tripack, const float* aabb8,
                                  const int* ids, const float* keys,
                                  const int* ncand, int n_cols, int r_blk,
                                  unsigned long long* words, float* t_out,
                                  int* idx_out, unsigned long long* stats,
                                  int device, void* stream) {
  if (n <= 0 || n_cols < 1 || r_blk < 1 || words == nullptr ||
      reinterpret_cast<size_t>(tripack) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = ptt::walk_grid(n, r_blk, n_cols);
  if (stats == nullptr)
    walker_nearest_kernel<false><<<grid, ptt::kThreads, 0, st>>>(
        o3, d3, n, tripack, aabb8, ids, keys, ncand, n_cols, r_blk, words,
        stats);
  else
    walker_nearest_kernel<true><<<grid, ptt::kThreads, 0, st>>>(
        o3, d3, n, tripack, aabb8, ids, keys, ncand, n_cols, r_blk, words,
        stats);
  const cudaError_t walked = cudaGetLastError();
  if (walked != cudaSuccess) return static_cast<int>(walked);
  finish_kernel<<<(n + ptt::kThreads - 1) / ptt::kThreads, ptt::kThreads, 0,
                  st>>>(words, n, t_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
