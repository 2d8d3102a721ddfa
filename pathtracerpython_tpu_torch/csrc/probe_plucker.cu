// P1: what the Plücker side products cost on this card's CUDA cores and on
// its tensor cores, beside the classic Möller–Trumbore test.
//
// Replaces the TPU probe scripts/mxu_probe.py (plucker_kernel on the matrix
// unit, mt_kernel on the vector unit): one tile of triangles against a
// wavefront of rays, per-ray (t, index) of the nearest hit, t = 3e38 and
// index = 2^31 - 1 on a miss. Four variants on the same inputs:
//
//   0  classic Möller–Trumbore (mt.cuh's mt_core, K1's test), float32 on
//      the CUDA cores: the yardstick;
//   1  Plücker, the three sides as float32 multiplies and adds on the CUDA
//      cores (plucker.cuh's plucker_side), four rays a thread;
//   2  Plücker with the three sides as one pass of TF32
//      wgmma.mma_async.m64n64k8 on the tensor cores: 64 triangles x 64 rays
//      x K = 8, the K of the TPU pack (edge direction | edge moment | 0 0)
//      . (o x d | d | 0 0);
//   3  the same with the 3xTF32 split: each operand x = hi + lo, both TF32,
//      and side = hi.lo + lo.hi + hi.hi (small terms first), which recovers
//      about 21 mantissa bits for three times the matrix work.
//
// Sign test first, in variants 1-3: the three sides' signs decide a pair,
// and only a pair whose sides agree (about 0.2% of the probe's pairs)
// computes the plane's t, with its division, and merges it. What the other
// pairs cost on the CUDA cores is the sign test (sides_agree: two three-way
// integer maxima of the sides' bits and two compares, exactly
// plucker_inside, zeros of either sign included). The order of operations
// inside each side and inside the plane is plucker.cuh's, so each variant
// keeps its plain version's gate (probes/mma_probe.py).
//
// Variants 2 and 3, one warpgroup (128 threads) a block, 256 rays a block
// in four groups of 64:
// - The triangle operands are split into TF32 hi and lo parts once per
//   pack, by the wrapper (probes/mma_probe.py: tf32_tiles), and laid out as
//   the shared-memory image of a tile: for each 64-row tile the hi parts of
//   the three edges, the plane rows (n | v0 | valid | occluder), the lo
//   parts, each edge part 64 rows x 8 TF32 values in K-major 8 x 16-byte
//   core matrices (no swizzle). The kernel converts nothing per tile.
// - One cp.async.bulk a tile (the TMA's plain bulk copy) lands it in one of
//   two stages, completing an mbarrier: the next tile's copy runs while
//   this one is swept, and each copied tile serves the block's four ray
//   groups, so the L2 traffic is a quarter of one group a block's.
// - The block's rays form the B operands once: o x d | d | 0 0, split, in
//   the same core-matrix layout, a group's 64 rays an operand, and o and d
//   beside them for the plane.
// - A step sweeps one tile against one ray group: each edge is one wgmma
//   (one pass) or three into one accumulator (3xTF32), A = 64 triangle
//   rows, B = 64 rays, both read from shared memory by descriptor. The
//   three edges' accumulators hold one (triangle, ray) pair at the same
//   register index, so the sign test is register-local: 32 pairs a thread
//   become one 32-bit mask.
// - The accumulators are free once the mask is taken, so the next step's
//   product is issued before this step's epilogue runs: the tensor cores
//   and the CUDA cores overlap within the warpgroup, and other blocks on
//   the SM fill the gaps. The loop is peeled so that every product it
//   issues is waited for at the top of the next pass.
// - An inside pair of a valid row is queued in shared memory (its tile row
//   and ray); when the tile's four groups are swept, the block's threads
//   take the queue one pair each, so that the planes' loads, divisions and
//   atomics of a tile overlap instead of running one after another in the
//   lane that found them, which set most of the kernel's time. A pair reads its triangle's plane row and its
//   ray's o and d from shared memory, and merges (t, index) into its ray's
//   64-bit key by a shared-memory atomicMin: t > 0, so its bits order as
//   the floats, and the key's low word breaks ties to the smaller index,
//   the plain version's lexicographic merge.
//
// What bounds them: the tensor-core work the function needs is 36 flops a
// pair a pass, 3 sides of 6 multiply-adds (0.0098 ms a pass for the
// probe's 1.34e8 pairs at 495 TFLOP/s; the instruction also multiplies
// each edge's two zero pad columns, which the bound does not count); the
// sign test about six instructions a pair on the CUDA cores; the rest is
// the plane on the inside pairs and a block's fixed cost (its rays, its
// first copy).
#include <cstdint>

#include <cuda_runtime.h>

#include "mt.cuh"
#include "plucker.cuh"

namespace {

constexpr int kMiss = 2147483647;

__global__ void __launch_bounds__(ptt::kThreads)
probe_cores_kernel(const float* __restrict__ o3, const float* __restrict__ d3,
                   int n, const float* __restrict__ pack, int t_count,
                   float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ ptt::ClassicForm::Tile tile;
  const size_t stride = static_cast<size_t>(n);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (live) {
    ox = o3[i];
    oy = o3[stride + i];
    oz = o3[2 * stride + i];
    dx = d3[i];
    dy = d3[stride + i];
    dz = d3[2 * stride + i];
  }
  const ptt::ClassicForm::Ray ray =
      ptt::ClassicForm::make_ray(ox, oy, oz, dx, dy, dz);
  float best_t = ptt::kBig;
  int best_idx = kMiss;
  for (int base = 0; base < t_count; base += ptt::kTile) {
    const int rows = min(ptt::kTile, t_count - base);
    __syncthreads();
    ptt::ClassicForm::load(tile, pack, base, rows, -1);
    __syncthreads();
    if (live) {
      for (int j = 0; j < rows; ++j) {
        float t;
        if (ptt::ClassicForm::use(tile, j) &&
            ptt::ClassicForm::hit(tile, j, ray, t) && t < best_t) {
          best_t = t;
          best_idx = base + j;
        }
      }
    }
  }
  if (live) {
    t_out[i] = best_t;
    idx_out[i] = best_idx;
  }
}

// plucker_inside on the sides' bits: a float is > 0 exactly when its bits
// as a signed int are > 0, and >= 0 (-0 included) exactly when its bits as
// an unsigned int are <= 0x80000000. All <= 0 or all >= 0 is then two
// three-way integer maxima (Hopper's DPX) and two compares, no branch,
// zeros of either sign included.
__device__ __forceinline__ bool sides_agree_bits(int a, int b, int c) {
  // both tests, not a short circuit: two predicates, no branch
  return (__vimax3_s32(a, b, c) <= 0) |
         (__vimax3_u32(static_cast<unsigned>(a), static_cast<unsigned>(b),
                       static_cast<unsigned>(c)) <= 0x80000000u);
}

__device__ __forceinline__ bool sides_agree(float s0, float s1, float s2) {
  return sides_agree_bits(__float_as_int(s0), __float_as_int(s1),
                          __float_as_int(s2));
}

// ---- variant 1: the sides on the CUDA cores, sign test first ------------

// rays a thread: a tile row's six 16-byte loads serve four pair tests,
// so the float32 units, not the shared-memory loads, set the pace
constexpr int kFmaRays = 4;
constexpr int kFmaThreads = 128;

__global__ void __launch_bounds__(kFmaThreads)
probe_fma_kernel(const float* __restrict__ o3, const float* __restrict__ d3,
                 int n, const float* __restrict__ pack36, int t_count,
                 float* __restrict__ t_out, int* __restrict__ idx_out) {
  __shared__ ptt::PluckerTile tile;
  // the rays' origins, read by inside pairs only
  __shared__ float org[3][kFmaRays * kFmaThreads];
  const size_t stride = static_cast<size_t>(n);
  const int first = blockIdx.x * (kFmaRays * kFmaThreads) + threadIdx.x;
  float mx[kFmaRays], my[kFmaRays], mz[kFmaRays];
  float dx[kFmaRays], dy[kFmaRays], dz[kFmaRays];
  float best_t[kFmaRays];
  int best_idx[kFmaRays];
#pragma unroll
  for (int r = 0; r < kFmaRays; ++r) {
    const int i = first + r * kFmaThreads;
    const bool live = i < n;
    const float ox = live ? o3[i] : 0.f;
    const float oy = live ? o3[stride + i] : 0.f;
    const float oz = live ? o3[2 * stride + i] : 0.f;
    dx[r] = live ? d3[i] : 0.f;
    dy[r] = live ? d3[stride + i] : 0.f;
    dz[r] = live ? d3[2 * stride + i] : 0.f;
    const ptt::PluckerForm::Ray ray =
        ptt::PluckerForm::make_ray(ox, oy, oz, dx[r], dy[r], dz[r]);
    mx[r] = ray.mx;
    my[r] = ray.my;
    mz[r] = ray.mz;
    const int k = r * kFmaThreads + threadIdx.x;
    org[0][k] = ox;
    org[1][k] = oy;
    org[2][k] = oz;
    best_t[r] = ptt::kBig;
    best_idx[r] = kMiss;
  }
  for (int base = 0; base < t_count; base += ptt::kTile) {
    const int rows = min(ptt::kTile, t_count - base);
    __syncthreads();
    ptt::PluckerForm::load(tile, pack36, base, rows, -1);
    __syncthreads();
    for (int j = 0; j < rows; ++j) {
      if (!tile.use[j]) continue;
      const float4* q =
          reinterpret_cast<const float4*>(tile.rows + j * ptt::kPluckerCols);
      const float4 q0 = q[0], q1 = q[1], q2 = q[2], q3 = q[3], q4 = q[4],
                   q5 = q[5];
      // the rays whose sides agree, one bit each: one rare branch a row
      unsigned in = 0;
#pragma unroll
      for (int r = 0; r < kFmaRays; ++r) {
        const float s0 = ptt::plucker_side(q0, q1, mx[r], my[r], mz[r], dx[r],
                                           dy[r], dz[r]);
        const float s1 = ptt::plucker_side(q2, q3, mx[r], my[r], mz[r], dx[r],
                                           dy[r], dz[r]);
        const float s2 = ptt::plucker_side(q4, q5, mx[r], my[r], mz[r], dx[r],
                                           dy[r], dz[r]);
        in |= sides_agree(s0, s1, s2) ? 1u << r : 0u;
      }
      if (in) {
#pragma unroll
        for (int r = 0; r < kFmaRays; ++r) {
          const int k = r * kFmaThreads + threadIdx.x;
          float t;
          if ((in >> r & 1u) &&
              ptt::plucker_plane(q[6], q[7], org[0][k], org[1][k], org[2][k],
                                 dx[r], dy[r], dz[r], t) &&
              t < best_t[r]) {
            best_t[r] = t;
            best_idx[r] = base + j;
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kFmaRays; ++r) {
    const int i = first + r * kFmaThreads;
    if (i < n) {
      t_out[i] = best_t[r];
      idx_out[i] = best_idx[r];
    }
  }
}

// ---- variants 2 and 3: the sides on the tensor cores (wgmma) ------------

constexpr int kMmaRows = 64;      // triangles a tile: wgmma's M
constexpr int kMmaRays = 64;      // rays a group: wgmma's N
constexpr int kGroups = 4;        // ray groups a block: each tile serves four
constexpr int kBlockRays = kGroups * kMmaRays;
constexpr int kMmaThreads = 128;  // one warpgroup
constexpr int kAccRegs = kMmaRows * kMmaRays / kMmaThreads;  // 32 an edge
// One edge part (or the plane rows): 64 rows x 8 floats, 2 KB.
constexpr int kPartFloats = kMmaRows * 8;
// A tile: hi e0 | hi e1 | hi e2 | plane | lo e0 | lo e1 | lo e2
// (probes/mma_probe.py: tf32_tiles); one pass copies the first four parts.
constexpr int kPlaneAt = 3 * kPartFloats;
constexpr int kLoAt = 4 * kPartFloats;
constexpr int kTileFloats = 7 * kPartFloats;
// K-major operands without swizzle: 8-row x 16-byte core matrices, a row's
// two 16-byte halves of K one core matrix (128 bytes) apart, 8-row groups
// 256 bytes apart. Element (row r, k) is at float
// (r / 8) * 64 + (k / 4) * 32 + (r % 8) * 4 + k % 4.
constexpr uint32_t kLeadingBytes = 128;  // between the K halves
constexpr uint32_t kStrideBytes = 256;   // between 8-row groups

// Inside pairs a tile may queue for its plane epilogue; past it a thread
// computes its pair's plane itself.
constexpr int kQueue = 256;
static_assert(kBlockRays <= 256 && kMmaRows <= 256, "a queue entry's fields");

struct MmaShared {
  float tiles[2][kTileFloats];             // the two stages
  float b[kGroups][2][kMmaRays * 8];       // a group's B operand, hi and lo
  float ray[kBlockRays][6];                // o, d
  unsigned long long best[kBlockRays];     // t bits << 32 | index
  unsigned long long full[2];              // a stage's copy has landed
  unsigned queue[kQueue];                  // tile row << 8 | ray in block
  unsigned queued[2];                      // a tile's count, by its parity
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float to_tf32(float x) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return __uint_as_float(u);
}

// The wgmma descriptor of a K-major operand at ``p`` (16-byte aligned),
// laid out as above: start address, leading and stride byte offsets in
// 16-byte units, base offset 0, no swizzle.
__device__ __forceinline__ uint64_t operand_desc(const float* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kLeadingBytes >> 4) << 16) |
         (static_cast<uint64_t>(kStrideBytes >> 4) << 32);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

// Wait for the phase of ``bar`` with ``parity`` to complete. A copy that
// never lands traps the kernel (an error at the next synchronise) rather
// than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 26)) asm volatile("trap;");
  }
}

// One thread: copy ``bytes`` from ``src`` into the stage at ``dst``,
// completing ``bar`` when they have landed.
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous product.
__device__ __forceinline__ void fence_acc(float (&d)[3][kAccRegs]) {
#pragma unroll
  for (int e = 0; e < 3; ++e)
#pragma unroll
    for (int i = 0; i < kAccRegs; ++i)
      asm volatile("" : "+f"(d[e][i])::"memory");
}

// d (64 x 64, float32) = a (64 x 8) . b (64 x 8)^T (+ d when ``accumulate``),
// TF32 operands in shared memory by descriptor.
__device__ __forceinline__ void wgmma_tf32(float (&d)[kAccRegs], uint64_t a,
                                           uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, %32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The three sides of a staged tile against one ray group's B operand
// (b: hi, b + 512 floats: lo), issued and committed as one group:
// acc[e] = edge e's side products.
template <bool Split>
__device__ __forceinline__ void issue_sides(float (&acc)[3][kAccRegs],
                                            const float* tile,
                                            const float* b) {
  const uint64_t b_hi = operand_desc(b);
  const uint64_t b_lo = operand_desc(b + kMmaRays * 8);
  fence_acc(acc);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int e = 0; e < 3; ++e) {
    const uint64_t a_hi = operand_desc(tile + e * kPartFloats);
    if (Split) {
      // the small terms first
      wgmma_tf32(acc[e], a_hi, b_lo, 0);
      wgmma_tf32(acc[e], operand_desc(tile + kLoAt + e * kPartFloats), b_hi,
                 1);
      wgmma_tf32(acc[e], a_hi, b_hi, 1);
    } else {
      wgmma_tf32(acc[e], a_hi, b_hi, 0);
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  fence_acc(acc);
}

// An accumulator's bits, read by an instruction the compiler cannot see
// through: a plain bit cast would let it carry the accumulators across the
// loop as integers, with moves from the tensor cores' registers right after
// each issue, which ptxas answers by waiting for the product there.
__device__ __forceinline__ int acc_bits(float x) {
  int bits;
  asm volatile("mov.b32 %0, %1;" : "=r"(bits) : "f"(x));
  return bits;
}

// Wait for the issued product and take its sign test: bit p of the result
// is accumulator register p's pair.
__device__ __forceinline__ unsigned sign_mask(float (&acc)[3][kAccRegs]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(acc);
  unsigned mask = 0;
#pragma unroll
  for (int p = 0; p < kAccRegs; ++p)
    mask |= sides_agree_bits(acc_bits(acc[0][p]), acc_bits(acc[1][p]),
                             acc_bits(acc[2][p]))
                ? 1u << p
                : 0u;
  return mask;
}

// The plane of (tile row ``row``, block ray ``ray_i``), merged into the
// ray's key.
__device__ __forceinline__ void plane_pair(const MmaShared& sm,
                                           const float* plane,
                                           unsigned long long* best, int base,
                                           int row, int ray_i) {
  const float4 q6 = *reinterpret_cast<const float4*>(plane + row * 8);
  const float4 q7 = *reinterpret_cast<const float4*>(plane + row * 8 + 4);
  const float* r = sm.ray[ray_i];
  float t;
  if (q7.z > 0.5f &&
      ptt::plucker_plane(q6, q7, r[0], r[1], r[2], r[3], r[4], r[5], t))
    atomicMin(best + ray_i,
              (static_cast<unsigned long long>(__float_as_uint(t)) << 32) |
                  static_cast<unsigned>(base + row));
}

// Queue the pairs of ``mask`` (accumulator register p = 4 i + j: tile row
// row0 + 8 (j >= 2), ray col0 + 8 i + (j & 1) of group g) for their
// tile's epilogue; a pair past the queue's end is done here.
__device__ __forceinline__ void queue_pairs(MmaShared& sm, unsigned mask,
                                            int parity, const float* plane,
                                            int base, int g, int row0,
                                            int col0) {
  while (mask) {
    const int p = __ffs(mask) - 1;
    mask &= mask - 1;
    const int row = row0 + ((p & 2) << 2);
    const int ray_i = g * kMmaRays + ((p >> 2) << 3) + col0 + (p & 1);
    const unsigned slot = atomicAdd(&sm.queued[parity], 1u);
    if (slot < kQueue)
      sm.queue[slot] = static_cast<unsigned>(row << 8 | ray_i);
    else
      plane_pair(sm, plane, sm.best, base, row, ray_i);
  }
}

// Tile k's epilogue, once every thread has queued its pairs: the queued
// planes, one pair a thread, so that their loads, divisions and atomics
// overlap; then the other parity's count is cleared for tile k + 1 (every
// thread read it before tile k began).
__device__ __forceinline__ void tile_epilogue(MmaShared& sm, int k, int tid) {
  __syncthreads();
  const unsigned n = min(sm.queued[k & 1], static_cast<unsigned>(kQueue));
  const float* plane = sm.tiles[k & 1] + kPlaneAt;
  for (unsigned i = tid; i < n; i += kMmaThreads)
    plane_pair(sm, plane, sm.best, k * kMmaRows, sm.queue[i] >> 8,
               sm.queue[i] & 0xFF);
  if (tid == 0) sm.queued[(k + 1) & 1] = 0u;
  __syncthreads();
}

// This thread's accumulator registers whose tile row is valid: bit p is
// row row0 + 8 (p & 2 ? 1 : 0).
__device__ __forceinline__ unsigned valid_rows(const float* plane, int row0) {
  return (plane[row0 * 8 + 6] > 0.5f ? 0x33333333u : 0u) |
         (plane[(row0 + 8) * 8 + 6] > 0.5f ? 0xCCCCCCCCu : 0u);
}

// Steps s = 0 .. n_tiles * kGroups - 1 sweep tile s / kGroups against ray
// group s % kGroups; step s + 1's product is issued before step s's plane
// epilogue, and a stage is refilled two tiles ahead once its tile's last
// group is done.
template <bool Split>
__global__ void __launch_bounds__(kMmaThreads, 4)
probe_wgmma_kernel(const float* __restrict__ o3, const float* __restrict__ d3,
                   int n, const float* __restrict__ tiles, int n_tiles,
                   float* __restrict__ t_out, int* __restrict__ idx_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  MmaShared& sm = *reinterpret_cast<MmaShared*>(smem);
  constexpr uint32_t kCopyBytes = (Split ? kTileFloats : kLoAt) * 4;
  const int tid = threadIdx.x;
  const int ray0 = blockIdx.x * kBlockRays;
  // stage s's barrier is full0 + 8 s
  const uint32_t full0 = smem_addr(&sm.full[0]);
  if (tid == 0) {
    mbar_init(full0);
    mbar_init(full0 + 8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int k = 0; k < 2 && k < n_tiles; ++k)
      copy_tile(sm.tiles[k], tiles + static_cast<size_t>(k) * kTileFloats,
                kCopyBytes, full0 + 8 * k);
  }
  // the rays' B operands (o x d | d | 0 0), one row per ray and part
  const size_t stride = static_cast<size_t>(n);
  for (int item = tid; item < 2 * kBlockRays; item += kMmaThreads) {
    const int r = item % kBlockRays, lo = item / kBlockRays;
    const int i = ray0 + r;
    const bool live = i < n;
    const float ox = live ? o3[i] : 0.f, oy = live ? o3[stride + i] : 0.f;
    const float oz = live ? o3[2 * stride + i] : 0.f;
    const float dx = live ? d3[i] : 0.f, dy = live ? d3[stride + i] : 0.f;
    const float dz = live ? d3[2 * stride + i] : 0.f;
    const ptt::PluckerForm::Ray ray =
        ptt::PluckerForm::make_ray(ox, oy, oz, dx, dy, dz);
    float k8[8] = {ray.mx, ray.my, ray.mz, dx, dy, dz, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float hi = to_tf32(k8[k]);
      k8[k] = lo ? to_tf32(k8[k] - hi) : hi;
    }
    const int g = r / kMmaRays, rr = r % kMmaRays;
    float* b = sm.b[g][lo] + (rr >> 3) * 64 + (rr & 7) * 4;
    *reinterpret_cast<float4*>(b) = make_float4(k8[0], k8[1], k8[2], k8[3]);
    *reinterpret_cast<float4*>(b + 32) =
        make_float4(k8[4], k8[5], k8[6], k8[7]);
    if (item < 2) sm.queued[item] = 0u;
    if (!lo) {
      float* keep = sm.ray[r];
      keep[0] = ox;
      keep[1] = oy;
      keep[2] = oz;
      keep[3] = dx;
      keep[4] = dy;
      keep[5] = dz;
      sm.best[r] =
          (static_cast<unsigned long long>(__float_as_uint(ptt::kBig))
           << 32) |
          static_cast<unsigned>(kMiss);
    }
  }
  // the B operands, written by the threads, are read by the tensor cores
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = warp * 16 + (lane >> 2);
  const int col0 = (lane & 3) * 2;
  const int steps = n_tiles * kGroups;
  float acc[3][kAccRegs];
  if (steps > 0) {
    mbar_wait(full0, 0);
    issue_sides<Split>(acc, sm.tiles[0], sm.b[0][0]);
  }
  unsigned valid = 0;
  for (int s = 0; s + 1 < steps; ++s) {
    const int k = s / kGroups, g = s % kGroups;
    const float* plane = sm.tiles[k & 1] + kPlaneAt;
    if (g == 0) valid = valid_rows(plane, row0);
    const unsigned mask = sign_mask(acc) & valid;
    const int k1 = (s + 1) / kGroups, g1 = (s + 1) % kGroups;
    if (g1 == 0) mbar_wait(full0 + 8 * (k1 & 1), (k1 >> 1) & 1);
    // step s + 1's product runs under step s's queueing and tile k's
    // epilogue
    issue_sides<Split>(acc, sm.tiles[k1 & 1], sm.b[g1][0]);
    queue_pairs(sm, mask, k & 1, plane, k * kMmaRows, g, row0, col0);
    if (g == kGroups - 1) {
      tile_epilogue(sm, k, tid);
      // every thread is done with tile k's stage: refill it two tiles on
      if (tid == 0 && k + 2 < n_tiles) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        copy_tile(sm.tiles[k & 1],
                  tiles + static_cast<size_t>(k + 2) * kTileFloats,
                  kCopyBytes, full0 + 8 * (k & 1));
      }
    }
  }
  if (steps > 0) {
    const int k = n_tiles - 1;
    const float* plane = sm.tiles[k & 1] + kPlaneAt;
    if (kGroups == 1) valid = valid_rows(plane, row0);
    queue_pairs(sm, sign_mask(acc) & valid, k & 1, plane, k * kMmaRows,
                kGroups - 1, row0, col0);
    tile_epilogue(sm, k, tid);
  }
  __syncthreads();
  for (int r = tid; r < kBlockRays && ray0 + r < n; r += kMmaThreads) {
    const unsigned long long key = sm.best[r];
    t_out[ray0 + r] = __uint_as_float(static_cast<unsigned>(key >> 32));
    idx_out[ray0 + r] = static_cast<int>(key & 0xFFFFFFFFu);
  }
}

template <bool Split>
cudaError_t launch_wgmma(const float* o3, const float* d3, int n,
                         const float* tiles, int n_tiles, float* t_out,
                         int* idx_out, cudaStream_t s) {
  const cudaError_t set = cudaFuncSetAttribute(
      probe_wgmma_kernel<Split>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(MmaShared)));
  if (set != cudaSuccess) return set;
  probe_wgmma_kernel<Split>
      <<<(n + kBlockRays - 1) / kBlockRays, kMmaThreads, sizeof(MmaShared),
         s>>>(o3, d3, n, tiles, n_tiles, t_out, idx_out);
  return cudaGetLastError();
}

}  // namespace

// o3, d3: float32 [3, n] (d3 unit length); tripack: float32 [t_count, 12];
// pack36: float32 [t_count, 36], 16-byte aligned, the Plücker pack of
// tripack; tiles: float32 [ceil(t_count / 64), 3584], 16-byte aligned, the
// TF32 tiles of pack36 (probes/mma_probe.py: tf32_tiles); variant: 0 to 3
// as above; t_out: float32 [n]; idx_out: int32 [n]. Launches on ``stream``
// of CUDA device ``device`` and returns cudaGetLastError() as an int
// (0 = launched).
extern "C" int ptt_probe_plucker(const float* o3, const float* d3, int n,
                                 const float* tripack, const float* pack36,
                                 const float* tiles, int t_count, int variant,
                                 float* t_out, int* idx_out, int device,
                                 void* stream) {
  if (n <= 0 || t_count < 0 || variant < 0 || variant > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (t_count + kMmaRows - 1) / kMmaRows;
  switch (variant) {
    case 0:
      probe_cores_kernel
          <<<(n + ptt::kThreads - 1) / ptt::kThreads, ptt::kThreads, 0, s>>>(
              o3, d3, n, tripack, t_count, t_out, idx_out);
      break;
    case 1: {
      const int rays = kFmaRays * kFmaThreads;
      probe_fma_kernel<<<(n + rays - 1) / rays, kFmaThreads, 0, s>>>(
          o3, d3, n, pack36, t_count, t_out, idx_out);
      break;
    }
    case 2:
      return static_cast<int>(launch_wgmma<false>(o3, d3, n, tiles, n_tiles,
                                                   t_out, idx_out, s));
    default:
      return static_cast<int>(launch_wgmma<true>(o3, d3, n, tiles, n_tiles,
                                                  t_out, idx_out, s));
  }
  return static_cast<int>(cudaGetLastError());
}
