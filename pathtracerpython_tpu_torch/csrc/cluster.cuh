// Device code shared by the cluster walks: the sparse sweeps K5
// (sparse_nearest.cu), K6 (sparse_any_hit.cu) and K7
// (sparse_any_hit_idx.cu), and the walker sweeps K8 (walker_nearest.cu) and
// K9 (walker_any_hit.cu): the per-ray slab test against a cluster's AABB,
// the staging of a cluster's triangles into shared memory, the mapping of a
// CTA onto a slice of one ray block, the split walk's work units (of the
// nearest sweeps K5 in both forms and K8, and of the any-hit sweeps K6 in
// both forms and K9, any_hit_walk.cuh), and the nearest sweeps' 64-bit
// merge and bound read.
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
//
// The split walk. A block's front-to-back list is cut into segments of
// kSegment consecutive slots, and the unit of work is (slice of the block's
// rays, segment): CTA (x, y) of the grid that walk_grid gives owns slice x
// and the slots [y kSegment, (y + 1) kSegment) of its block's list, and
// leaves at once when the list is shorter. The grid is sized from the list width
// the host knows (C, or the walker's columns); which units hold slots is
// read on the device from ncand, so the launch reads nothing back. Units
// are numbered segment-major (y outermost), and the card starts CTAs in
// about that order: every block's front segment first, so that the later
// segments start from the bounds the front ones found. A block whose list
// fits one segment is walked by one unit, as before the split.
//
// The merge. Each lane's best (t, global index) lives in a 64-bit word of a
// scratch buffer, all ones ("no hit yet") before the launch: t's float bits
// above the index's. A hit has t > T_MIN > 0, and the bits of positive
// floats sort as unsigned integers in the order of their values, with equal
// bits for equal values; indices are >= 0. So the unsigned order of the
// words is the lexicographic (t, index) order, the one that the serial
// walk's strict t < best_t, ties to the smaller index, realises. A unit
// publishes a better best with atomicMin; the minimum does not depend on
// the order of the atomics, so the word ends at the minimum over all
// published hits whatever order the units ran in. A word still all ones
// after the walk is a miss (t = 0, index -1).
//
// The bound. A lane's bound is the minimum of its own register (kept as a
// word, starting at (kBig, 0): a hit replaces it only when t < kBig, as the
// serial walk's did) and a relaxed read of its scratch word, refreshed once
// per slot in units of blocks of more than one segment. The per-lane gate
// (slab hit, entry < bound t + SLAB_EPS) and the stop (no lane of the CTA,
// or warp, with the slot's block bound <= its bound t + SLAB_EPS) read that
// bound. Why every cluster that can hold the winner is still visited: let w
// be the lexicographic minimum over the hits of every cluster of the list,
// which is the serial walk's (and the dense K1's) winner. Every register
// and every word holds the initial value or a real hit, so never less than
// w: a stale read only loosens a bound, never tightens it past w. The gate
// rejects a cluster only when every hit in it has t above the bound's t
// (SLAB_EPS covers the slab test's rounding), and w's t is at most that, so
// the unit that owns w's slot visits w's cluster (nor can its stop come
// before that slot: the slot's block bound is at most the ray's own entry).
// There its register becomes w, is published, and no word goes below it.
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

// Adds a warp's sum of ``count`` to ``*counter``.
__device__ __forceinline__ void add_warp_count(unsigned long long* counter,
                                               unsigned long long count) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if ((threadIdx.x & 31) == 0 && count) atomicAdd(counter, count);
}

// ---- The split walk of the nearest sweeps (see the top of this file) ----

// List slots per work unit of the nearest walks. Measured against 8, 32,
// 64 and 128 on the card, the 100k field's first and second bounce
// (PERF.md): 16 beat 32, 64 and 128 at both, every kernel; 8 reads 2-5%
// faster and is untaken. The any-hit walks have their own
// (any_hit_walk.cuh: kAnyHitSegment).
constexpr int kSegment = 16;
constexpr unsigned long long kNoHitWord = ~0ull;  // scratch word: no hit yet

// The counters a counting instance of K5 or K8 adds to, in this order.
enum WalkCounter { kUnitsLaunched = 0, kUnitsStoppedAtOnce = 1, kVisits = 2 };

// A lane's hit (t > T_MIN, index >= 0) as one word, ordered as (t, index).
__device__ __forceinline__ unsigned long long hit_word(float t, int idx) {
  return (static_cast<unsigned long long>(__float_as_uint(t)) << 32) |
         static_cast<unsigned int>(idx);
}

// The t of a word (kBig for a register that holds no hit yet).
__device__ __forceinline__ float word_t(unsigned long long word) {
  return __uint_as_float(static_cast<unsigned int>(word >> 32));
}

// The smaller of two words: the lexicographic (t, index) minimum.
__device__ __forceinline__ unsigned long long word_min(unsigned long long a,
                                                       unsigned long long b) {
  return a < b ? a : b;
}

// A lane's register before any hit: a hit must have t < kBig to replace it.
__device__ __forceinline__ unsigned long long start_word() {
  return hit_word(kBig, 0);
}

// The relaxed read of a lane's scratch word: another CTA may lower it at
// any time, and any value it held since the launch is a valid bound.
__device__ __forceinline__ unsigned long long read_word(
    const unsigned long long* words, int lane) {
  return *reinterpret_cast<const volatile unsigned long long*>(words + lane);
}

// Publishes a lane's better best.
__device__ __forceinline__ void publish_word(unsigned long long* words,
                                             int lane,
                                             unsigned long long best) {
  atomicMin(words + lane, best);
}

// One unit of the split walk: this CTA's slice of a ray block and the
// list slots [first, end) of the block's list, ``count`` long.
struct WalkUnit {
  BlockSlice me;
  int count, first, end;
  bool shared;  // the block's list spans more than one unit
};

// ``Segment``: the unit's list slots (kSegment for the nearest walks).
template <int Segment = kSegment>
__device__ __forceinline__ WalkUnit walk_unit(int r_blk, int n,
                                              const int* __restrict__ ncand) {
  const BlockSlice me = block_slice(r_blk, n);
  const int count = ncand[me.block];
  const int first = blockIdx.y * Segment;
  return WalkUnit{me, count, first, min(first + Segment, count),
                  count > Segment};
}

// The grid of the split walk: the slices of the ray blocks, times the
// segments of ``segment`` slots of the longest list a block can have
// (``n_cols`` slots).
inline dim3 walk_grid(int n, int r_blk, int n_cols, int segment = kSegment) {
  return dim3(slice_ctas(n, r_blk), (n_cols + segment - 1) / segment);
}

// The outputs of one lane from its merged word: t and index, or t = 0 and
// index -1 where no unit published a hit.
__device__ __forceinline__ void finish_lane(
    const unsigned long long* __restrict__ words, int lane,
    float* __restrict__ t_out, int* __restrict__ idx_out) {
  const unsigned long long w = words[lane];
  const bool hit = w != kNoHitWord;
  t_out[lane] = hit ? word_t(w) : 0.0f;
  idx_out[lane] = hit ? static_cast<int>(static_cast<unsigned int>(w)) : -1;
}

}  // namespace ptt
