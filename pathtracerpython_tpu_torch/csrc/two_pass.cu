// The select-and-compact kernel of the two-pass protocol of the uncached
// cluster sweeps (kernels/sparse.py: K5, K6 and K3's sparse sweeps over
// truncated lists), and the occluder cache's compaction (K7's two passes):
// in one kernel, per lane, the finality test (the lane's lower bound ne on
// the entry of every cluster its block's truncated list dropped, and
// whether pass 2 must sweep the lane again), and the stable compaction of
// the unfinished lanes into the m slots of pass 2 (their lane indices and
// their rays); a second small launch finishes on the device: it parks the
// slots past the count, and chooses the branch. Nothing is read back to
// the host.
//
// Replaces no TPU kernel: the JAX package computes the same in plain XLA
// (pathtracerpython_tpu/kernels/sparse_pallas.py _lane_unseen_bound, :430,
// over _lane_slab_enter_exit, :406; the finality tests of
// _sparse_nearest_entry, :1993, and sparse_any_hit_cm, :2124;
// _compact_select, :1933; _gather_parked, :1949; and the branch of
// lax.cond, :2014, :2137, :1302). Its plain twins are kernels/sparse.py:
// two_pass_flags_plain and select_compact_plain, which give the same
// flags, bound, slots, count, rays and branch bit for bit.
//
// The rules, per lane:
// - ne: the lane's own slab entry (clamped to >= 0) into each of the first
//   lane_m dropped clusters that it hits (a miss bounds nothing), and
//   beyond those the block key ``far`` of the next dropped candidate (kBig
//   when nothing more was dropped); the front-to-back order makes the block
//   keys monotone, and a block key bounds every lane's entry from below.
// - Unfinished, nearest: ne < t1 + SLAB_EPS, t1 the lane's pass-1 best read
//   from K5's merged 64-bit word (kBig where no unit published a hit).
//   Any-hit: not occluded in pass 1, able to be blocked at all (maxd -
//   T_MIN > T_MIN, as the any-hit walks' gate), and ne < maxd + SLAB_EPS.
//   Both also ask that the lane's ray meet the box of the whole scene (the
//   union of the clusters' boxes): a ray that misses it misses every
//   cluster, and the slab test is monotone in the box, so such a lane (a
//   parked one, or one that leaves the scene) is final whatever ``far``
//   says. The JAX package's test lacks this last condition; it changes no
//   result, only which lanes reach pass 2. The compact entry takes the
//   flags as they are (the cache's open lanes).
// - Compaction: the s-th unfinished lane in lane order goes to slot s
//   while s < m: sel[s] = lane, and its ray (and window) into the pass-2
//   buffers. The count of unfinished lanes goes to a device int.
// - Finish: when count <= m, slots [count, m) are parked (PARK_ORIGIN,
//   PARK_DIR, window 1; their block lists no cluster) and their sel is the
//   sentinel n; when count > m, every slot is so parked and ``taken`` is
//   set: the caller's fallback sweeps the whole wavefront over the full
//   lists, whose counts the finish copies to ncand_fb (0 for every block
//   when not taken, so an untaken fallback's units exit at once).
//
// Design. What bounds it on an H100 is bytes: each lane's ray (24 bytes)
// and its pass-1 state (8 or 5 bytes) read once, each of the m slots
// written once (sel, 24 bytes of ray, 4 of window), the drops and the
// boxes they name once; the slab tests are 22 operations each, 9 a lane,
// far under the float32 rate. So:
// - one thread a lane, 256 lanes a CTA, and every lane of a CTA in one ray
//   block (a CTA covers one slice of 256 lanes of a block, as cluster.cuh's
//   walks): one warp stages the block's lane_m drop boxes (two float4 loads
//   each), their keys and ``far`` in shared memory, and the per-lane loop
//   reads shared memory only, where every lane once chased drop_keys ->
//   drop_ids -> a 32-byte aabb8 row through global memory;
// - the scene box comes in from the caller, cached per scene;
// - the compaction is single-pass: a lane's rank in its warp from
//   __ballot_sync and __popc, the eight warps' totals scanned in the CTA,
//   the CTAs' offsets by decoupled look-back (one 64-bit status word a
//   tile: its aggregate, then its inclusive prefix; a warp reads 32
//   predecessors at a time). CTAs take their tile index from an atomic
//   counter in the order they start, so the look-back never waits on a
//   tile that has not been scheduled. Positions are exact integer prefix
//   sums in lane order, whatever the schedule: the slots are
//   torch.nonzero's order and _compact_select's;
// - the tile of the last index knows the count (its inclusive prefix) and
//   writes it; the finish launch reads it in stream order;
// - the compact entry reads a ray only for a lane that takes a slot.
//
// Arithmetic: cluster.cuh's slab test, the reciprocal by IEEE division
// (no fast math; built with -fmad=false), min and max exact, so ne and the
// flags round as the plain twin's.
#include <cuda_runtime.h>

#include <cstdint>

#include "cluster.cuh"
#include "mt.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = ptt::kThreads / 32;
// Dropped slots a lane gets its own entry for, at most (shared memory:
// 32 bytes a slot)
constexpr int kMaxLaneM = 1024;
// ops/sort.py: PARK_ORIGIN = (0, kParkOriginY, 0), PARK_DIR = (0,
// kParkDirY, 0)
constexpr float kParkOriginY = 1.0e6f;
constexpr float kParkDirY = 1.0f;
// A tile's status word: its flag in the high 32 bits, its count in the low
constexpr unsigned long long kAggregate = 1ull << 32;  // the tile's own
constexpr unsigned long long kInclusive = 2ull << 32;  // tiles 0..t

// Where the unfinished lanes go: the m slots of pass 2.
struct Slots {
  int m;
  unsigned long long* __restrict__ status;  // [tiles], zeroed
  unsigned int* __restrict__ next_tile;     // zeroed
  long long* __restrict__ sel;              // [m]
  int* __restrict__ count;                  // [1]
  float* __restrict__ o2;                   // [3, m]
  float* __restrict__ d2;                   // [3, m]
  float* __restrict__ md2;                  // [m], or null
  const float* __restrict__ maxd;           // [n], or null
};

// What a truncated pass dropped, per ray block.
struct Drops {
  const float* __restrict__ aabb8;
  const float* __restrict__ scene_box;
  const int* __restrict__ ids;
  const float* __restrict__ keys;
  const float* __restrict__ far;
  int lane_m, r_blk;
};

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

// This CTA's tile, in the order the CTAs start; warp 0 calls it.
__device__ __forceinline__ int take_tile(unsigned int* next_tile) {
  int tile = 0;
  if ((threadIdx.x & 31) == 0)
    tile = static_cast<int>(atomicAdd(next_tile, 1u));
  return __shfl_sync(kFull, tile, 0);
}

__device__ __forceinline__ unsigned long long read_status(
    const unsigned long long* word) {
  return *reinterpret_cast<const volatile unsigned long long*>(word);
}

// Warp 0: publishes the tile's count ``total``, looks back over the tiles
// before it and publishes its inclusive prefix; returns the count of the
// tiles before it. The status of a tile before ``tile`` is read until it
// holds a count; that tile took its index earlier, so it runs.
__device__ unsigned long long look_back(int tile, unsigned total,
                                        unsigned long long* status) {
  const int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) atomicExch(status, kInclusive | total);
    return 0;
  }
  if (lane == 0) atomicExch(status + tile, kAggregate | total);
  unsigned long long before = 0;
  for (int base = tile - 1;; base -= 32) {
    const int pred = base - lane;  // lane 0 reads the nearest tile
    unsigned long long w;
    do {
      w = pred >= 0 ? read_status(status + pred) : kInclusive;
    } while (__any_sync(kFull, (w >> 32) == 0));
    const unsigned inclusive = __ballot_sync(kFull, (w >> 32) == 2);
    const int stop = inclusive ? __ffs(inclusive) - 1 : 31;
    unsigned v = lane <= stop ? static_cast<unsigned>(w) : 0u;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(kFull, v, off);
    before += __shfl_sync(kFull, v, 0);
    if (inclusive) break;
  }
  if (lane == 0) atomicExch(status + tile, kInclusive | (before + total));
  return before;
}

// Every thread of the CTA: the slot of this thread's lane among the
// unfinished lanes in lane order (meaningful where ``flag``). The tile of
// index tiles - 1 writes the count.
__device__ __forceinline__ int slot_of(int tile, int tiles, bool flag,
                                       const Slots& c) {
  __shared__ int warp_base[kWarps];
  __shared__ int tile_base;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned votes = __ballot_sync(kFull, flag);
  const int rank = __popc(votes & ((1u << lane) - 1u));
  if (lane == 0) warp_base[warp] = __popc(votes);
  __syncthreads();
  if (warp == 0) {
    const int own = lane < kWarps ? warp_base[lane] : 0;
    int inclusive = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, inclusive, off);
      if (lane >= off) inclusive += v;
    }
    const unsigned total = static_cast<unsigned>(
        __shfl_sync(kFull, inclusive, 31));
    if (lane < kWarps) warp_base[lane] = inclusive - own;
    const unsigned long long before = look_back(tile, total, c.status);
    if (lane == 0) {
      tile_base = static_cast<int>(before);
      if (tile == tiles - 1) *c.count = static_cast<int>(before + total);
    }
  }
  __syncthreads();
  return tile_base + warp_base[warp] + rank;
}

// A survivor's slot: its lane and its ray (and window).
__device__ __forceinline__ void take_slot(const Slots& c, int s, int lane,
                                          const float o[3],
                                          const float d[3]) {
  const size_t m = static_cast<size_t>(c.m);
  c.sel[s] = lane;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    c.o2[k * m + s] = o[k];
    c.d2[k * m + s] = d[k];
  }
  if (c.md2 != nullptr) c.md2[s] = c.maxd[lane];
}

template <class Reach>
__global__ void __launch_bounds__(ptt::kThreads)
select_kernel(const float* __restrict__ o3, const float* __restrict__ d3,
              int n, int tiles, Reach reach_of, Drops drops, Slots c,
              unsigned char* __restrict__ flags_out,
              float* __restrict__ ne_out) {
  // staged by warp 0: the block's drop boxes (col 6 of a staged box: 1
  // where its slot names a candidate), ``far`` and the tile
  extern __shared__ float4 staged[];
  __shared__ int s_tile;
  __shared__ float s_far;
  const int slices = (drops.r_blk + ptt::kThreads - 1) / ptt::kThreads;
  if (threadIdx.x < 32) {
    const int tile = take_tile(c.next_tile);
    const int block = tile / slices;
    const size_t row = static_cast<size_t>(block) * drops.lane_m;
    const float4* boxes = reinterpret_cast<const float4*>(drops.aabb8);
    for (int j = threadIdx.x; j < drops.lane_m; j += 32) {
      float4 lo = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 hi = lo;
      if (drops.keys[row + j] < ptt::kBig) {
        const size_t id = static_cast<size_t>(drops.ids[row + j]);
        lo = boxes[2 * id];
        hi = boxes[2 * id + 1];
        hi.z = 1.0f;
      }
      staged[2 * j] = lo;
      staged[2 * j + 1] = hi;
    }
    if (threadIdx.x == 0) {
      s_tile = tile;
      s_far = drops.far[block];
    }
  }
  __syncthreads();
  const int tile = s_tile;
  const int within = (tile % slices) * ptt::kThreads + threadIdx.x;
  const int lane = (tile / slices) * drops.r_blk + within;
  const bool live = within < drops.r_blk && lane < n;
  const size_t stride = static_cast<size_t>(n);
  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 0.0f};
  bool flag = false;
  if (live) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = o3[k * stride + lane];
      d[k] = d3[k * stride + lane];
    }
    const ptt::SlabRay ray = ptt::make_slab_ray(o[0], o[1], o[2], d[0],
                                                d[1], d[2]);
    float ne = s_far;
    for (int j = 0; j < drops.lane_m; ++j) {
      const float* box = reinterpret_cast<const float*>(staged + 2 * j);
      if (box[6] == 0.0f) continue;
      float enter0;
      if (ptt::slab_hit(box, ray, enter0)) ne = fminf(ne, enter0);
    }
    float reach;
    const bool open = reach_of.open(lane, reach);
    float scene_enter;
    const bool meets = ptt::slab_hit(drops.scene_box, ray, scene_enter);
    flag = open && meets && ne < reach + ptt::kSlabEps;
    if (flags_out != nullptr) flags_out[lane] = flag;
    if (ne_out != nullptr) ne_out[lane] = ne;
  }
  const int s = slot_of(tile, tiles, flag, c);
  if (flag && s < c.m) take_slot(c, s, lane, o, d);
}

// The compact entry: the flags are given; tiles of 256 consecutive lanes.
__global__ void __launch_bounds__(ptt::kThreads)
compact_kernel(const float* __restrict__ o3, const float* __restrict__ d3,
               int n, int tiles, const unsigned char* __restrict__ flags,
               Slots c) {
  __shared__ int s_tile;
  if (threadIdx.x < 32) {
    const int tile = take_tile(c.next_tile);
    if (threadIdx.x == 0) s_tile = tile;
  }
  __syncthreads();
  const int tile = s_tile;
  const int lane = tile * ptt::kThreads + threadIdx.x;
  const bool flag = lane < n && flags[lane] != 0;
  const int s = slot_of(tile, tiles, flag, c);
  if (flag && s < c.m) {
    const size_t stride = static_cast<size_t>(n);
    float o[3], d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = o3[k * stride + lane];
      d[k] = d3[k * stride + lane];
    }
    take_slot(c, s, lane, o, d);
  }
}

// The finish: slot i past the count (every slot where the count exceeds
// m) parked, its sel the sentinel n; ``taken``; the fallback's counts.
__global__ void __launch_bounds__(ptt::kThreads)
finish_kernel(int n, Slots c, const int* __restrict__ ncand, int nrb,
              int* __restrict__ ncand_fb, unsigned char* __restrict__ taken) {
  const int i = blockIdx.x * ptt::kThreads + threadIdx.x;
  const int count = *c.count;
  const bool over = count > c.m;
  if (i == 0) *taken = over;
  if (i < c.m && (over || i >= count)) {
    const size_t m = static_cast<size_t>(c.m);
    c.sel[i] = n;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c.o2[k * m + i] = k == 1 ? kParkOriginY : 0.0f;
      c.d2[k * m + i] = k == 1 ? kParkDirY : 0.0f;
    }
    if (c.md2 != nullptr) c.md2[i] = 1.0f;
  }
  if (ncand_fb != nullptr && i < nrb) ncand_fb[i] = over ? ncand[i] : 0;
}

bool slots_ok(const Slots& c) {
  return c.m >= 1 && c.status != nullptr && c.next_tile != nullptr &&
         c.sel != nullptr && c.count != nullptr && c.o2 != nullptr &&
         c.d2 != nullptr && (c.md2 == nullptr || c.maxd != nullptr);
}

// Launches the finish after the select or compact kernel.
int finish(int n, const Slots& c, const int* ncand, int nrb, int* ncand_fb,
           unsigned char* taken, cudaStream_t stream) {
  const cudaError_t ran = cudaGetLastError();
  if (ran != cudaSuccess) return static_cast<int>(ran);
  const int fb = ncand_fb != nullptr ? nrb : 0;
  const int work = c.m > fb ? c.m : fb;
  finish_kernel<<<(work + ptt::kThreads - 1) / ptt::kThreads, ptt::kThreads,
                  0, stream>>>(n, c, ncand, nrb, ncand_fb, taken);
  return static_cast<int>(cudaGetLastError());
}

// The scratch a call's status words and tile counter take, in 64-bit
// words: kernels/sparse.py allocates it zeroed.
Slots make_slots(int m, unsigned long long* scratch, int tiles,
                 long long* sel, int* count, float* o2, float* d2,
                 float* md2, const float* maxd) {
  return Slots{m, scratch, reinterpret_cast<unsigned int*>(scratch + tiles),
               sel, count, o2, d2, md2, maxd};
}

template <class Reach>
int launch_select(const float* o3, const float* d3, int n, Reach reach,
                  const float* aabb8, const float* scene_box,
                  const int* drop_ids, const float* drop_keys,
                  const float* far, int lane_m, int r_blk, int m,
                  const int* ncand, int nrb, unsigned long long* scratch,
                  long long* sel, int* count, unsigned char* taken,
                  float* o2, float* d2, float* md2, const float* maxd,
                  int* ncand_fb, unsigned char* flags_out, float* ne_out,
                  int device, void* stream) {
  const int slices = (r_blk + ptt::kThreads - 1) / ptt::kThreads;
  const int tiles = r_blk < 1 ? 0 : ptt::slice_ctas(n, r_blk);
  const Slots c = make_slots(m, scratch, tiles, sel, count, o2, d2, md2,
                             maxd);
  if (n <= 0 || lane_m < 0 || lane_m > kMaxLaneM || r_blk < 1 ||
      slices < 1 || !slots_ok(c) || taken == nullptr ||
      (ncand_fb != nullptr && ncand == nullptr) ||
      reinterpret_cast<std::uintptr_t>(aabb8) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Drops drops{aabb8, scene_box, drop_ids, drop_keys, far, lane_m,
                    r_blk};
  select_kernel<Reach><<<tiles, ptt::kThreads, 32 * lane_m, st>>>(
      o3, d3, n, tiles, reach, drops, c, flags_out, ne_out);
  return finish(n, c, ncand, nrb, ncand_fb, taken, st);
}

}  // namespace

// The nearest sweep's entry. o3, d3: float32 [3, n] (d3 unit length);
// words: uint64 [n], K5's (or K3's sparse nearest's) merged words of pass
// 1; aabb8: float32 [C, 8], 16-byte aligned; scene_box: float32 [8],
// min.xyz | max.xyz of every cluster box; drop_ids: int32 [ceil(n / r_blk),
// lane_m] and drop_keys: float32 [ceil(n / r_blk), lane_m], each block's
// first lane_m dropped list slots (a key of kBig or more: no candidate);
// far: float32 [ceil(n / r_blk)]; m: the slots of pass 2 (>= 1); ncand:
// int32 [nrb], the full lists' counts, or null; scratch: uint64 [tiles +
// 1] zeroed, tiles = ceil(n / r_blk) * ceil(r_blk / 256); sel: int64 [m];
// count: int32 [1]; taken: bool (one byte) [1]; o2, d2: float32 [3, m];
// md2: float32 [m], or null; ncand_fb: int32 [nrb], or null (then ncand is
// not read); flags_out: bool (one byte) [n], or null; ne_out: float32 [n],
// or null. Launches the select and the finish on ``stream`` of CUDA device
// ``device`` and returns cudaGetLastError() as an int (0 = launched).
extern "C" int ptt_two_pass_nearest_select(
    const float* o3, const float* d3, int n, const unsigned long long* words,
    const float* aabb8, const float* scene_box, const int* drop_ids,
    const float* drop_keys, const float* far, int lane_m, int r_blk, int m,
    const int* ncand, int nrb, unsigned long long* scratch, long long* sel,
    int* count, unsigned char* taken, float* o2, float* d2, float* md2,
    int* ncand_fb, unsigned char* flags_out, float* ne_out, int device,
    void* stream) {
  if (words == nullptr || md2 != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_select(o3, d3, n, NearestReach{words}, aabb8, scene_box,
                       drop_ids, drop_keys, far, lane_m, r_blk, m, ncand, nrb,
                       scratch, sel, count, taken, o2, d2, nullptr, nullptr,
                       ncand_fb, flags_out, ne_out, device, stream);
}

// The any-hit's entry: occ: bool (one byte) [n], K6's (or K3's sparse
// any-hit's) marks of pass 1; maxd: float32 [n]; md2: float32 [m], the
// pass-2 windows (required); the rest as the nearest entry's.
extern "C" int ptt_two_pass_any_hit_select(
    const float* o3, const float* d3, int n, const unsigned char* occ,
    const float* maxd, const float* aabb8, const float* scene_box,
    const int* drop_ids, const float* drop_keys, const float* far,
    int lane_m, int r_blk, int m, const int* ncand, int nrb,
    unsigned long long* scratch, long long* sel, int* count,
    unsigned char* taken, float* o2, float* d2, float* md2, int* ncand_fb,
    unsigned char* flags_out, float* ne_out, int device, void* stream) {
  if (occ == nullptr || maxd == nullptr || md2 == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_select(o3, d3, n, AnyHitReach{occ, maxd}, aabb8, scene_box,
                       drop_ids, drop_keys, far, lane_m, r_blk, m, ncand, nrb,
                       scratch, sel, count, taken, o2, d2, md2, maxd,
                       ncand_fb, flags_out, ne_out, device, stream);
}

// The compact entry (the occluder cache's pass 2): flags: bool (one byte)
// [n], the lanes to compact; maxd: float32 [n] and md2: float32 [m], both
// or neither; scratch: uint64 [ceil(n / 256) + 1] zeroed; the rest as the
// nearest entry's.
extern "C" int ptt_select_compact(
    const float* o3, const float* d3, int n, const unsigned char* flags,
    const float* maxd, int m, const int* ncand, int nrb,
    unsigned long long* scratch, long long* sel, int* count,
    unsigned char* taken, float* o2, float* d2, float* md2, int* ncand_fb,
    int device, void* stream) {
  const int tiles = (n + ptt::kThreads - 1) / ptt::kThreads;
  const Slots c = make_slots(m, scratch, tiles, sel, count, o2, d2, md2,
                             maxd);
  if (n <= 0 || flags == nullptr || !slots_ok(c) || taken == nullptr ||
      (maxd == nullptr) != (md2 == nullptr) ||
      (ncand_fb != nullptr && ncand == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  compact_kernel<<<tiles, ptt::kThreads, 0, st>>>(o3, d3, n, tiles, flags,
                                                  c);
  return finish(n, c, ncand, nrb, ncand_fb, taken, st);
}
