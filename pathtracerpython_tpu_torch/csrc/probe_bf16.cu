// P2: does the Möller–Trumbore pair test run faster in bf16 than in float32
// on this card's CUDA cores?
//
// Replaces the TPU probe scripts/bf16_probe.py (make_kernel): one tile of
// triangles against a wavefront of rays, the same operations in float32 and
// in bf16 (operands cast at load, every product, sum and difference rounded
// to bf16, the reciprocal taken in float32 and rounded, the comparisons in
// float32), output the number of triangles each ray hits, as a float. A
// bf16 pre-test ahead of the float32 sweep can only pay if this ratio is
// near 2.
//
// Variant 0, float32: mt.cuh's mt_core, one ray per thread, the tile staged
// in shared memory 256 rows at a time with e1 and e2 formed at load, as K1.
// Variant 1, bf16: packed __nv_bfloat162 arithmetic, two rays per thread
// (the two halves), each triangle value duplicated into both halves when
// the tile is staged, with e1 and e2 formed in bf16 from the cast vertices.
// Products and sums are __hmul2 / __hsub2 / __hadd2, never a fused
// multiply-add (and the library is compiled with -fmad=false), so every
// operation rounds once to bf16, like the plain PyTorch version on bf16
// tensors (kernels of probes/bf16_probe.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

using bf2 = __nv_bfloat162;

__global__ void __launch_bounds__(ptt::kThreads)
probe_f32_kernel(const float* __restrict__ o3, const float* __restrict__ d3,
                 int n, const float* __restrict__ tripack, int t_count,
                 float* __restrict__ count_out) {
  __shared__ ptt::TriTile tile;
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
  int count = 0;
  for (int base = 0; base < t_count; base += ptt::kTile) {
    const int rows = min(ptt::kTile, t_count - base);
    __syncthreads();
    ptt::load_tile(tile, tripack, base, rows, -1);
    __syncthreads();
    if (live) {
      for (int j = 0; j < rows; ++j) {
        float t;
        count += tile.use[j] && ptt::mt_hit(tile, j, ox, oy, oz, dx, dy, dz, t);
      }
    }
  }
  if (live) count_out[i] = static_cast<float>(count);
}

// v0, e1, e2 of a tile's rows, each value in both halves of a bf162
struct Bf16Tile {
  unsigned v[9][ptt::kTile];  // the bits of a bf162
  unsigned char use[ptt::kTile];
};

__device__ __forceinline__ unsigned bits_of(bf2 x) {
  return *reinterpret_cast<const unsigned*>(&x);
}

__device__ __forceinline__ bf2 bf2_of(unsigned bits) {
  return *reinterpret_cast<const bf2*>(&bits);
}

// rays i0 and i1 of component row x as the two halves, 0 past the end
__device__ __forceinline__ bf2 ray_pair(const float* __restrict__ x, int i0,
                                        int n) {
  return __floats2bfloat162_rn(i0 < n ? x[i0] : 0.f,
                               i0 + 1 < n ? x[i0 + 1] : 0.f);
}

__device__ __forceinline__ bf2 dot_bf16(bf2 ax, bf2 ay, bf2 az, bf2 bx, bf2 by,
                                        bf2 bz) {
  return __hadd2(__hadd2(__hmul2(ax, bx), __hmul2(ay, by)), __hmul2(az, bz));
}

// a * b - c * d
__device__ __forceinline__ bf2 det2_bf16(bf2 a, bf2 b, bf2 c, bf2 d) {
  return __hsub2(__hmul2(a, b), __hmul2(c, d));
}

__global__ void __launch_bounds__(ptt::kThreads)
probe_bf16_kernel(const float* __restrict__ o3, const float* __restrict__ d3,
                  int n, const float* __restrict__ tripack, int t_count,
                  float* __restrict__ count_out) {
  __shared__ Bf16Tile tile;
  const size_t stride = static_cast<size_t>(n);
  // this thread's two rays
  const int i0 = 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  const int i1 = i0 + 1;
  const bool live0 = i0 < n, live1 = i1 < n;
  const bf2 ox = ray_pair(o3, i0, n);
  const bf2 oy = ray_pair(o3 + stride, i0, n);
  const bf2 oz = ray_pair(o3 + 2 * stride, i0, n);
  const bf2 dx = ray_pair(d3, i0, n);
  const bf2 dy = ray_pair(d3 + stride, i0, n);
  const bf2 dz = ray_pair(d3 + 2 * stride, i0, n);
  int count0 = 0, count1 = 0;
  for (int base = 0; base < t_count; base += ptt::kTile) {
    const int rows = min(ptt::kTile, t_count - base);
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const float* p = tripack + static_cast<size_t>(base + r) * ptt::kPackCols;
      bf2 c[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) c[k] = __float2bfloat162_rn(p[k]);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        tile.v[k][r] = bits_of(c[k]);
        tile.v[3 + k][r] = bits_of(__hsub2(c[3 + k], c[k]));
        tile.v[6 + k][r] = bits_of(__hsub2(c[6 + k], c[k]));
      }
      tile.use[r] = p[ptt::kValidCol] > 0.5f;
    }
    __syncthreads();
    if (live0) {
      for (int j = 0; j < rows; ++j) {
        const bf2 v0x = bf2_of(tile.v[0][j]), v0y = bf2_of(tile.v[1][j]);
        const bf2 v0z = bf2_of(tile.v[2][j]), e1x = bf2_of(tile.v[3][j]);
        const bf2 e1y = bf2_of(tile.v[4][j]), e1z = bf2_of(tile.v[5][j]);
        const bf2 e2x = bf2_of(tile.v[6][j]), e2y = bf2_of(tile.v[7][j]);
        const bf2 e2z = bf2_of(tile.v[8][j]);
        const bf2 pvx = det2_bf16(dy, e2z, dz, e2y);
        const bf2 pvy = det2_bf16(dz, e2x, dx, e2z);
        const bf2 pvz = det2_bf16(dx, e2y, dy, e2x);
        const bf2 det = dot_bf16(e1x, e1y, e1z, pvx, pvy, pvz);
        const float2 detf = __bfloat1622float2(det);
        const bool m0 = fabsf(detf.x) > ptt::kDetEps;
        const bool m1 = fabsf(detf.y) > ptt::kDetEps;
        const bf2 inv = __floats2bfloat162_rn(1.0f / (m0 ? detf.x : 1.0f),
                                              1.0f / (m1 ? detf.y : 1.0f));
        const bf2 tvx = __hsub2(ox, v0x);
        const bf2 tvy = __hsub2(oy, v0y);
        const bf2 tvz = __hsub2(oz, v0z);
        const bf2 u = __hmul2(dot_bf16(tvx, tvy, tvz, pvx, pvy, pvz), inv);
        const bf2 qvx = det2_bf16(tvy, e1z, tvz, e1y);
        const bf2 qvy = det2_bf16(tvz, e1x, tvx, e1z);
        const bf2 qvz = det2_bf16(tvx, e1y, tvy, e1x);
        const bf2 v = __hmul2(dot_bf16(dx, dy, dz, qvx, qvy, qvz), inv);
        const bf2 t = __hmul2(dot_bf16(e2x, e2y, e2z, qvx, qvy, qvz), inv);
        const float2 uf = __bfloat1622float2(u);
        const float2 vf = __bfloat1622float2(v);
        const float2 tf = __bfloat1622float2(t);
        const bool use = tile.use[j];
        count0 += use && m0 && uf.x >= 0.0f && vf.x >= 0.0f &&
                  uf.x + vf.x <= 1.0f && tf.x > ptt::kTMin;
        count1 += use && m1 && uf.y >= 0.0f && vf.y >= 0.0f &&
                  uf.y + vf.y <= 1.0f && tf.y > ptt::kTMin;
      }
    }
  }
  if (live0) count_out[i0] = static_cast<float>(count0);
  if (live1) count_out[i1] = static_cast<float>(count1);
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
  if (variant == 0) {
    const int blocks = (n + ptt::kThreads - 1) / ptt::kThreads;
    probe_f32_kernel<<<blocks, ptt::kThreads, 0, s>>>(o3, d3, n, tripack,
                                                      t_count, count_out);
  } else {
    const int pairs = (n + 1) / 2;
    const int blocks = (pairs + ptt::kThreads - 1) / ptt::kThreads;
    probe_bf16_kernel<<<blocks, ptt::kThreads, 0, s>>>(o3, d3, n, tripack,
                                                       t_count, count_out);
  }
  return static_cast<int>(cudaGetLastError());
}
