// P2: does the Möller–Trumbore pair test run faster in bf16 than in float32
// on this card's CUDA cores?
//
// Replaces the TPU probe scripts/bf16_probe.py (make_kernel): one tile of
// triangles against a wavefront of rays, the same operations in float32 and
// in bf16 (operands cast at load, every product, sum and difference rounded
// to bf16, the reciprocal taken in float32 and rounded), output the number
// of triangles each ray hits, as a float. A bf16 pre-test ahead of the
// float32 sweep can only pay if this ratio is near 2.
//
// Both variants run kRays = 4 rays a thread, for instruction-level
// parallelism and so that one tile row's shared-memory loads serve four
// pair tests; the tile is staged 256 rows at a time.
//
// Variant 0, float32: Möller–Trumbore in mt.cuh's order (mt_core), with the
// reciprocal as __frcp_rn (correctly rounded: the bits of 1.0f / det) and
// without the select that mt_core guards it with, whose value no counted
// pair reads; a tile row is three float4 (v0, e1, e2 formed at load, the
// valid flag).
//
// Variant 1, bf16: packed __nv_bfloat162 arithmetic, two rays a word, two
// words a thread. A tile row holds each bf16 value once (32 bytes: v0, e1,
// e2 formed in bf16 from the cast vertices, the valid flag), read as two
// 16-byte loads and broadcast into both halves of a word with one byte
// permute (__bfloat162bfloat162's). Products and sums are __hmul2 /
// __hsub2 / __hadd2, never fused (and the library is compiled with
// -fmad=false), so every operation rounds once, like the plain PyTorch
// version on bf16 tensors. What used to be a
// scalar tail now stays packed: the reciprocal of the two dets is two
// __frcp_rn of their exact float32 widening and one round-to-bf16 pack; the
// tests u >= 0, v >= 0, t > T_MIN and |det| > DET_EPS are packed bf16
// compares (a bf16 value exceeds a float32 threshold exactly when it
// exceeds the largest bf16 value not above it, so comparing against that
// value is exact), each giving a 16-bit mask a ray. Only u + v <= 1 is
// summed in float32 on the widened halves: the plain version sums in
// float32, and a bf16 sum would round where that one does not. A hit adds
// one to its ray's half of a packed counter.
//
// What bounds them: issue. Compiled with -fmad=false, neither fuses a
// product into an add, so each reaches at most half of a bound that counts
// an FMA as two flops: float32 about 60 instructions a pair, bf16 about 37
// (44 packed operations for two pairs, the reciprocals, the compares).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

using bf2 = __nv_bfloat162;

constexpr int kRays = 4;

__device__ __forceinline__ void load_rays(const float* __restrict__ o3,
                                          const float* __restrict__ d3, int n,
                                          int first, float (&o)[3][kRays],
                                          float (&d)[3][kRays]) {
  const size_t stride = static_cast<size_t>(n);
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = first + r * ptt::kThreads;
    const bool live = i < n;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o[c][r] = live ? o3[c * stride + i] : 0.f;
      d[c][r] = live ? d3[c * stride + i] : 0.f;
    }
  }
}

// ---- variant 0: float32 ------------------------------------------------

struct F32Tile {
  float4 rows[ptt::kTile][3];  // v0.xyz e1.x | e1.yz e2.xy | e2.z valid 0 0
};

// mt_core's arithmetic with the reciprocal as __frcp_rn
__device__ __forceinline__ bool mt_rcp(float4 q0, float4 q1, float4 q2,
                                       float ox, float oy, float oz, float dx,
                                       float dy, float dz) {
  const float v0x = q0.x, v0y = q0.y, v0z = q0.z;
  const float e1x = q0.w, e1y = q1.x, e1z = q1.y;
  const float e2x = q1.z, e2y = q1.w, e2z = q2.x;
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool not_par = fabsf(det) > ptt::kDetEps;
  const float inv_det = __frcp_rn(det);
  const float tvx = ox - v0x;
  const float tvy = oy - v0y;
  const float tvz = oz - v0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (dx * qvx + dy * qvy + dz * qvz) * inv_det;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  return not_par && u >= 0.0f && v >= 0.0f && u + v <= 1.0f &&
         t > ptt::kTMin;
}

__global__ void __launch_bounds__(ptt::kThreads)
probe_f32_kernel(const float* __restrict__ o3, const float* __restrict__ d3,
                 int n, const float* __restrict__ tripack, int t_count,
                 float* __restrict__ count_out) {
  __shared__ F32Tile tile;
  const int first = blockIdx.x * (kRays * ptt::kThreads) + threadIdx.x;
  float o[3][kRays], d[3][kRays];
  load_rays(o3, d3, n, first, o, d);
  int count[kRays] = {};
  for (int base = 0; base < t_count; base += ptt::kTile) {
    const int rows = min(ptt::kTile, t_count - base);
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const float* p =
          tripack + static_cast<size_t>(base + r) * ptt::kPackCols;
      const float v0x = p[0], v0y = p[1], v0z = p[2];
      tile.rows[r][0] = make_float4(v0x, v0y, v0z, p[3] - v0x);
      tile.rows[r][1] =
          make_float4(p[4] - v0y, p[5] - v0z, p[6] - v0x, p[7] - v0y);
      tile.rows[r][2] = make_float4(
          p[8] - v0z, p[ptt::kValidCol] > 0.5f ? 1.f : 0.f, 0.f, 0.f);
    }
    __syncthreads();
    for (int j = 0; j < rows; ++j) {
      const float4 q2 = tile.rows[j][2];
      if (q2.y == 0.f) continue;
      const float4 q0 = tile.rows[j][0], q1 = tile.rows[j][1];
#pragma unroll
      for (int r = 0; r < kRays; ++r)
        count[r] += mt_rcp(q0, q1, q2, o[0][r], o[1][r], o[2][r], d[0][r],
                           d[1][r], d[2][r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = first + r * ptt::kThreads;
    if (i < n) count_out[i] = static_cast<float>(count[r]);
  }
}

// ---- variant 1: packed bf16 --------------------------------------------

// A row: 16 bf16 slots, v0.xyz e1.xyz e2.xyz | valid (0xFFFF or 0) | 6 pad;
// slot s is half s % 2 of word s / 2 (even slots in the low half).
struct Bf16Tile {
  uint4 rows[ptt::kTile][2];
};

__device__ __forceinline__ unsigned bits_of(bf2 x) {
  return *reinterpret_cast<const unsigned*>(&x);
}

__device__ __forceinline__ bf2 bf2_of(unsigned bits) {
  return *reinterpret_cast<const bf2*>(&bits);
}

// a word's low or high bf16 in both halves
__device__ __forceinline__ bf2 low_both(unsigned w) {
  return bf2_of(__byte_perm(w, 0, 0x1010));
}
__device__ __forceinline__ bf2 high_both(unsigned w) {
  return bf2_of(__byte_perm(w, 0, 0x3232));
}

// the exact float32 value of a word's low or high bf16
__device__ __forceinline__ float low_f32(bf2 x) {
  return __uint_as_float(bits_of(x) << 16);
}
__device__ __forceinline__ float high_f32(bf2 x) {
  return __uint_as_float(bits_of(x) & 0xFFFF0000u);
}

__device__ __forceinline__ bf2 dot_bf16(bf2 ax, bf2 ay, bf2 az, bf2 bx, bf2 by,
                                        bf2 bz) {
  return __hadd2(__hadd2(__hmul2(ax, bx), __hmul2(ay, by)), __hmul2(az, bz));
}

// a * b - c * d
__device__ __forceinline__ bf2 det2_bf16(bf2 a, bf2 b, bf2 c, bf2 d) {
  return __hsub2(__hmul2(a, b), __hmul2(c, d));
}

struct Bf16Row {
  bf2 v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

// Both rays of the word pair (o, d) against one row: bit 0 set where the
// low ray hits, bit 16 where the high ray does.
__device__ __forceinline__ unsigned hits_bf16(const Bf16Row& w, bf2 ox, bf2 oy,
                                              bf2 oz, bf2 dx, bf2 dy, bf2 dz,
                                              bf2 det_eps, bf2 t_min) {
  const bf2 zero = __float2bfloat162_rn(0.0f);
  const bf2 pvx = det2_bf16(dy, w.e2z, dz, w.e2y);
  const bf2 pvy = det2_bf16(dz, w.e2x, dx, w.e2z);
  const bf2 pvz = det2_bf16(dx, w.e2y, dy, w.e2x);
  const bf2 det = dot_bf16(w.e1x, w.e1y, w.e1z, pvx, pvy, pvz);
  const bf2 inv = __floats2bfloat162_rn(__frcp_rn(low_f32(det)),
                                        __frcp_rn(high_f32(det)));
  const bf2 tvx = __hsub2(ox, w.v0x);
  const bf2 tvy = __hsub2(oy, w.v0y);
  const bf2 tvz = __hsub2(oz, w.v0z);
  const bf2 u = __hmul2(dot_bf16(tvx, tvy, tvz, pvx, pvy, pvz), inv);
  const bf2 qvx = det2_bf16(tvy, w.e1z, tvz, w.e1y);
  const bf2 qvy = det2_bf16(tvz, w.e1x, tvx, w.e1z);
  const bf2 qvz = det2_bf16(tvx, w.e1y, tvy, w.e1x);
  const bf2 v = __hmul2(dot_bf16(dx, dy, dz, qvx, qvy, qvz), inv);
  const bf2 t = __hmul2(dot_bf16(w.e2x, w.e2y, w.e2z, qvx, qvy, qvz), inv);
  const unsigned m = __hgt2_mask(__habs2(det), det_eps) &
                     __hge2_mask(u, zero) & __hge2_mask(v, zero) &
                     __hgt2_mask(t, t_min);
  const unsigned sum = (low_f32(u) + low_f32(v) <= 1.0f ? 0x1u : 0u) |
                       (high_f32(u) + high_f32(v) <= 1.0f ? 0x10000u : 0u);
  return m & sum;
}

__global__ void __launch_bounds__(ptt::kThreads)
probe_bf16_kernel(const float* __restrict__ o3, const float* __restrict__ d3,
                  int n, const float* __restrict__ tripack, int t_count,
                  float* __restrict__ count_out) {
  __shared__ Bf16Tile tile;
  constexpr int kWords = kRays / 2;
  const int first = blockIdx.x * (kRays * ptt::kThreads) + threadIdx.x;
  // the largest bf16 values not above the float32 thresholds
  const bf2 det_eps = __bfloat162bfloat162(__float2bfloat16_rz(ptt::kDetEps));
  const bf2 t_min = __bfloat162bfloat162(__float2bfloat16_rz(ptt::kTMin));
  // word q holds rays 2q (low half) and 2q + 1 (high half)
  bf2 o[3][kWords], d[3][kWords];
  {
    float of[3][kRays], df[3][kRays];
    load_rays(o3, d3, n, first, of, df);
#pragma unroll
    for (int q = 0; q < kWords; ++q)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        o[c][q] = __floats2bfloat162_rn(of[c][2 * q], of[c][2 * q + 1]);
        d[c][q] = __floats2bfloat162_rn(df[c][2 * q], df[c][2 * q + 1]);
      }
  }
  int count[kRays] = {};
  for (int base = 0; base < t_count; base += ptt::kTile) {
    const int rows = min(ptt::kTile, t_count - base);
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const float* p =
          tripack + static_cast<size_t>(base + r) * ptt::kPackCols;
      __nv_bfloat16 c[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) c[k] = __float2bfloat16_rn(p[k]);
      unsigned short s[10];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        s[k] = __bfloat16_as_ushort(c[k]);
        s[3 + k] = __bfloat16_as_ushort(__hsub(c[3 + k], c[k]));
        s[6 + k] = __bfloat16_as_ushort(__hsub(c[6 + k], c[k]));
      }
      s[9] = p[ptt::kValidCol] > 0.5f ? 0xFFFFu : 0u;
      const auto word = [&s](int k) {
        return static_cast<unsigned>(s[2 * k]) |
               (static_cast<unsigned>(s[2 * k + 1]) << 16);
      };
      tile.rows[r][0] = make_uint4(word(0), word(1), word(2), word(3));
      tile.rows[r][1] = make_uint4(word(4), 0u, 0u, 0u);
    }
    __syncthreads();
    unsigned packed[kWords] = {};  // two 16-bit counts a word, one a ray
    for (int j = 0; j < rows; ++j) {
      const uint4 a = tile.rows[j][0];
      const unsigned b = tile.rows[j][1].x;
      if ((b >> 16) == 0u) continue;  // not valid
      const Bf16Row w{low_both(a.x),  high_both(a.x), low_both(a.y),
                      high_both(a.y), low_both(a.z),  high_both(a.z),
                      low_both(a.w),  high_both(a.w), low_both(b)};
#pragma unroll
      for (int q = 0; q < kWords; ++q)
        packed[q] += hits_bf16(w, o[0][q], o[1][q], o[2][q], d[0][q], d[1][q],
                               d[2][q], det_eps, t_min);
    }
    // at most kTile hits a ray a tile: the 16-bit halves cannot overflow
#pragma unroll
    for (int q = 0; q < kWords; ++q) {
      count[2 * q] += packed[q] & 0xFFFFu;
      count[2 * q + 1] += packed[q] >> 16;
    }
  }
#pragma unroll
  for (int r = 0; r < kRays; ++r) {
    const int i = first + r * ptt::kThreads;
    if (i < n) count_out[i] = static_cast<float>(count[r]);
  }
}

}  // namespace

// o3, d3: float32 [3, n]; tripack: float32 [t_count, 12]; variant: 0 float32,
// 1 bf16; count_out: float32 [n], the triangles each ray hits. Launches on
// ``stream`` of CUDA device ``device`` and returns cudaGetLastError() as an
// int (0 = launched).
extern "C" int ptt_probe_bf16(const float* o3, const float* d3, int n,
                              const float* tripack, int t_count, int variant,
                              float* count_out, int device, void* stream) {
  if (n <= 0 || t_count < 0 || variant < 0 || variant > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rays = kRays * ptt::kThreads;
  const int blocks = (n + rays - 1) / rays;
  if (variant == 0)
    probe_f32_kernel<<<blocks, ptt::kThreads, 0, s>>>(o3, d3, n, tripack,
                                                      t_count, count_out);
  else
    probe_bf16_kernel<<<blocks, ptt::kThreads, 0, s>>>(o3, d3, n, tripack,
                                                       t_count, count_out);
  return static_cast<int>(cudaGetLastError());
}
