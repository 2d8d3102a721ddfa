// The split any-hit walk of the cluster shadow sweeps, shared by K6 and K3's
// cluster-sparse any-hit (sparse_any_hit.cu, the form a template parameter),
// K9 (walker_any_hit.cu) and K7 (sparse_any_hit_idx.cu): they differ only in
// their lists (kernels/sparse.py: window_lists and, for K7's first pass,
// guess_lists in blocks of 512; kernels/walker.py: walker_lists in blocks of
// 1280), in K6's form, and in the merge, a template parameter: K6 and K9
// merge by occlusion marks, K7 by each lane's first blocking slot.
//
// A ray is occluded by a valid occluder triangle (pack column 10, or 31 of
// the Plücker pack) with a forward hit at t < maxd - 1e-4; parked rays
// (maxd = 0) never are, and never ask for a cluster.
//
// Units. The units of the split nearest walks (cluster.cuh), of
// kAnyHitSegment slots: CTA (x, y) of walk_grid's grid owns slice x of a
// ray block (256 rays, one a thread) and the list slots [y S, (y + 1) S) of
// the block's list, numbered segment-major so that every block's front
// segment runs first. A
// unit past its block's ncand leaves at once, read on the device. A unit
// walks its slots front to back with the clusters' packed rows and boxes
// double-buffered in shared memory by cp.async.
//
// The merges. A lane has one word in a buffer that the wrapper fills before
// the launch and that units only ever lower or set; a unit that finds a
// blocking hit for the lane at slot s publishes it there, and the lane is
// done for the rest of that unit. OcclusionMarks (K6, K9): one byte, 0
// before the launch, set to 1. FirstBlockingSlot (K7): the lane's smallest
// blocking list slot, 2^31 - 1 ("none") before the launch, lowered to s by
// atomicMin; K7's outputs are read from it after the walk.
//
// Polling. In a block whose list spans more than one unit, a unit reads its
// lanes' words once a slot, one slot ahead so that the load overlaps the
// slot's work, and drops a lane that the word says it may drop at the slot
// it reaches: a marked lane (OcclusionMarks), or a lane whose first blocking
// slot is below that slot (FirstBlockingSlot). A unit of a front segment
// must not drop a lane that only a later segment has blocked: K7 would then
// name the later slot.
//
// The stop. A unit stops when none of its lanes is open with a window that
// reaches the slot's block bound (keys[s] <= maxd + SLAB_EPS). The bounds
// only grow along the list, and a lane's own clamped entry to a cluster is
// never below its block's bound (cluster.cuh), so no later slot can
// occlude a lane that the stop lets go. (The guess lists' bounds are all 0:
// there no unit stops before each of its lanes is blocked or dropped.)
//
// Why the bits do not depend on the order or the timing of the units. Let B
// be the OR, over the slots of the lane's list, of "the slot's cluster
// passes the lane's gate and holds a valid occluder row in a group box the
// lane meets (below) whose pair test blocks the lane". Every blocking hit a
// unit finds is such a row, so B = 0 leaves the mark 0. Where B = 1, take a
// slot s with such a row r. The unit that owns s either finds the lane
// marked already, or reaches s with the lane open: its stop cannot come
// first (the slot's bound is at most the lane's entry, below maxd +
// SLAB_EPS), the gate lets the cluster through (it is the same test), and
// the lane tests the cluster's rows in order up to its first blocking one,
// which is r or an earlier row; then it sets the mark. A stale read of a
// mark only keeps a lane open longer: more work, never another bit.
//
// Why K7's first blocking slot does not depend on them either. Let s* be
// the smallest slot with such a row for the lane (none where B = 0: then no
// unit publishes and the word stays "none"). Every slot a unit publishes
// blocks the lane, so no word ever goes below s*, and the minimum over the
// published slots does not depend on the order of the atomics. The unit
// that owns s* reaches it with the lane open: it drops the lane only on a
// word below the slot it reaches, and no word is below s*; it found no
// blocker for the lane before s* in its own slots, since s* is the
// smallest; and its stop and gate cannot pass over s*, as above. So it
// publishes s*, and the word ends at s*. A stale read is a word at or
// above the current one: it only keeps a lane open longer. The cull below
// decides which row of a cluster blocks first, not whether the cluster
// blocks a lane whose pair tests are conditioned.
//
// The in-cluster box cull. The JAX package gates each SUB_TILE slice of a
// cluster by its own box (sparse_pallas.py: cluster_sub_aabbs), and leaves
// it off on the TPU, where the predication stalls Mosaic's load pipeline.
// Here a visited cluster's 128 rows are culled at aabb.cuh's levels: 4 span
// boxes of 32 rows, 16 mid boxes of 8 rows and 64 group boxes of kGroup = 2
// rows, over the valid occluder rows, grown at build time
// (kernels/sparse.py: cluster_cull_boxes, from the dense sweeps' group boxes
// and cached per scene), met up to maxd * kCullReach by aabb.cuh's slab
// test. A warp tests its lanes that need the cluster against a span and
// skips it on a vote when none meets it, then the mids inside, then the
// groups; a lane that does not meet a box sits out what lies below it. The
// cull skips only pairs whose hit cannot lie in [0, maxd) wherever the pair
// test is conditioned (aabb.cuh states the limit). A second instance counts
// units launched, units stopped before their first slot, (lane, cluster)
// visits through the gate, box tests per level, and pairs tested.
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "aabb.cuh"
#include "cluster.cuh"
#include "mt.cuh"

namespace ptt {

constexpr int kClusterSpans = kClusterTris / kSpanRows;  // 4
constexpr int kClusterMids = kClusterTris / kMidRows;    // 16
constexpr int kClusterGroups = kClusterTris / kGroup;    // 64
// A cluster's boxes, in this order: spans | mids | groups (2688 bytes).
constexpr int kClusterBoxes = kClusterSpans + kClusterMids + kClusterGroups;
constexpr int kClusterBoxFloats = kClusterBoxes * kAabbCols;
constexpr unsigned kFullWarp = 0xffffffffu;
// List slots per unit. Measured on the card against 8, 16, 64 and 128, the
// 100k field's first and second bounce (PERF.md): 32 was the fastest
// at the second bounce, every kernel; 64 and 128 were faster at the first
// by up to 6% and slower at the second, and a render has one first bounce
// and two later ones. A visit is cheap once the cull has taken most of its
// pairs, so a unit's fixed cost (its first stage, its stop) weighs more
// than in the nearest walks, whose segments are shorter.
constexpr int kAnyHitSegment = 32;

static_assert(kClusterBoxFloats % 4 == 0, "boxes are copied 16 bytes at a time");

// The counters the counting instance adds to after cluster.cuh's
// WalkCounter (units launched, units stopped at once, visits).
enum AnyHitCounter {
  kSpanTests = 3,
  kMidTests = 4,
  kGroupTests = 5,
  kWalkPairsTested = 6
};

// The merge of K6 and K9 (see the top of this file): one byte a lane,
// zeroed before the launch, set to 1 by a unit that finds a blocker.
struct OcclusionMarks {
  unsigned char* occ;
  static constexpr int kUnread = 0;  // a word that drops no lane
  __device__ __forceinline__ int read(int lane) const {
    return reinterpret_cast<const volatile unsigned char*>(occ)[lane];
  }
  __device__ __forceinline__ static bool drops(int word, int) {
    return word != 0;
  }
  __device__ __forceinline__ void publish(int lane, int) const {
    occ[lane] = 1;
  }
};

// The merge of K7: the lane's first blocking list slot, kNoSlot before the
// launch, lowered by atomicMin. A lane is dropped at slot s only when a
// smaller slot blocks it.
constexpr int kNoSlot = 2147483647;
struct FirstBlockingSlot {
  int* first_slot;
  static constexpr int kUnread = kNoSlot;
  __device__ __forceinline__ int read(int lane) const {
    return reinterpret_cast<const volatile int*>(first_slot)[lane];
  }
  __device__ __forceinline__ static bool drops(int word, int slot) {
    return word < slot;
  }
  __device__ __forceinline__ void publish(int lane, int slot) const {
    atomicMin(first_slot + lane, slot);
  }
};

// Two visits' boxes and rows in shared memory. Reading the rows from global
// memory instead, where the cull lets a lane reach them, measured level
// (PERF.md).
template <class Form>
struct AnyHitStage {
  __align__(16) float boxes[2][kClusterBoxFloats];
  __align__(16) float rows[2][kClusterTris * Form::kCols];
};

// Starts the copy of cluster ``cl``'s boxes and rows into buffer ``b``.
template <class Form>
__device__ __forceinline__ void stage_visit(AnyHitStage<Form>& st, int b,
                                            const float* __restrict__ pack,
                                            const float* __restrict__ cull,
                                            int cl) {
  const float* src = cull + static_cast<size_t>(cl) * kClusterBoxFloats;
  for (int k = threadIdx.x; k < kClusterBoxFloats / 4; k += blockDim.x)
    __pipeline_memcpy_async(st.boxes[b] + 4 * k, src + 4 * k, 16);
  stage_cluster<Form::kCols>(st.rows[b], pack, cl);  // commits both
}

// One unit of the walk (see the top of this file), merged by ``merge``
// (OcclusionMarks or FirstBlockingSlot). Every thread of the CTA calls it.
template <class Form, bool kCount, class Merge>
__device__ __forceinline__ void split_any_hit(
    AnyHitStage<Form>& st, const float* __restrict__ o3,
    const float* __restrict__ d3, const float* __restrict__ maxd, int n,
    const float* __restrict__ pack, const float* __restrict__ aabb8,
    const float* __restrict__ cull, const int* __restrict__ ids,
    const float* __restrict__ keys, const int* __restrict__ ncand,
    int n_cols, int r_blk, const Merge merge,
    unsigned long long* __restrict__ stats) {
  const WalkUnit unit = walk_unit<kAnyHitSegment>(r_blk, n, ncand);
  if (unit.first >= unit.count) return;  // the same for every thread
  const BlockSlice& me = unit.me;
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
  const SlabRay ray = make_slab_ray(ox, oy, oz, dx, dy, dz);
  const typename Form::Ray pair_ray = Form::make_ray(ox, oy, oz, dx, dy, dz);
  const float reach = md * kCullReach;
  auto meets = [&](const float* box) {
    return box_meets(box_from(box, ox, oy, oz), ray.ix, ray.iy, ray.iz,
                     reach);
  };
  // t > T_MIN and t < md - T_MIN cannot both hold unless md - T_MIN > T_MIN
  const float t_cut = md - kTMin;
  const float gate = md + kSlabEps;
  const bool reads = me.live && unit.shared;  // other units merge its lanes
  bool open = me.live && t_cut > kTMin;  // not blocked here, can still be
  if (reads && open) open = !Merge::drops(merge.read(me.lane), unit.first);
  int seen = Merge::kUnread;  // the word as read for the next slot
  unsigned long long visits = 0, spans = 0, mids = 0, groups = 0, pairs = 0;

  const size_t row = static_cast<size_t>(me.block) * n_cols;
  // the unit's stop at its first slot, before anything is staged
  if (!__syncthreads_or(open && keys[row + unit.first] <= gate)) {
    if (kCount && threadIdx.x == 0) {
      atomicAdd(stats + kUnitsLaunched, 1ull);
      atomicAdd(stats + kUnitsStoppedAtOnce, 1ull);
    }
    return;
  }
  stage_visit(st, 0, pack, cull, ids[row + unit.first]);
  int cur = 0;
  for (int s = unit.first; s < unit.end; ++s) {
    const int cl = ids[row + s];
    if (Merge::drops(seen, s)) open = false;  // another unit's blocker
    wait_staged();
    // the unit's stop (decided above for the first slot); the barrier also
    // completes buffer cur and frees cur ^ 1, read in the previous step
    if (!__syncthreads_or(s == unit.first ||
                          (open && keys[row + s] <= gate)))
      break;
    if (s + 1 < unit.end)
      stage_visit(st, cur ^ 1, pack, cull, ids[row + s + 1]);
    if (reads && open) seen = merge.read(me.lane);
    float enter;
    const bool need = open &&
                      slab_hit(aabb8 + cl * kAabbCols, ray, enter) &&
                      enter < gate;
    if (kCount) visits += need;
    if (__any_sync(kFullWarp, need)) {
      const float* rows = st.rows[cur];
      const float* boxes = st.boxes[cur];
      const float* mid_boxes = boxes + kClusterSpans * kAabbCols;
      const float* group_boxes = mid_boxes + kClusterMids * kAabbCols;
      bool testing = need;  // needs the cluster and has not been blocked
      for (int sp = 0; sp < kClusterSpans; ++sp) {
        if (kCount) spans += testing;
        const bool in_span = testing && meets(boxes + sp * kAabbCols);
        if (!__any_sync(kFullWarp, in_span)) continue;
        for (int m = sp * (kSpanRows / kMidRows);
             m < (sp + 1) * (kSpanRows / kMidRows); ++m) {
          if (kCount) mids += in_span && testing;
          const bool in_mid =
              in_span && testing && meets(mid_boxes + m * kAabbCols);
          if (!__any_sync(kFullWarp, in_mid)) continue;
          for (int g = m * (kMidRows / kGroup);
               g < (m + 1) * (kMidRows / kGroup); ++g) {
            if (kCount) groups += in_mid && testing;
            bool in_group =
                in_mid && testing && meets(group_boxes + g * kAabbCols);
            if (!__any_sync(kFullWarp, in_group)) continue;
            for (int j = g * kGroup; j < (g + 1) * kGroup && in_group; ++j) {
              const float* p = rows + j * Form::kCols;
              if (!(p[Form::kValid] > 0.5f && p[Form::kOccluder] > 0.5f))
                continue;
              if (kCount) ++pairs;
              float t;
              if (Form::hit_row(p, pair_ray, t) && t < t_cut)
                in_group = testing = false;
            }
          }
        }
      }
      if (need && !testing) {
        open = false;
        merge.publish(me.lane, s);
      }
    }
    cur ^= 1;
  }
  wait_staged();  // no copy left in flight
  if (kCount) {
    if (threadIdx.x == 0) atomicAdd(stats + kUnitsLaunched, 1ull);
    add_warp_count(stats + kVisits, visits);
    add_warp_count(stats + kSpanTests, spans);
    add_warp_count(stats + kMidTests, mids);
    add_warp_count(stats + kGroupTests, groups);
    add_warp_count(stats + kWalkPairsTested, pairs);
  }
}

}  // namespace ptt
