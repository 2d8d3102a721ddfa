// K4 and K3's dense any-hit: dense shadow any-hit, one thread per ray, in
// the classic Möller–Trumbore form (K4) and in the Plücker form (K3,
// plucker.cuh); the form is the kernel's template parameter, the sweep and
// the merge are the same.
//
// Replaces the TPU kernel pathtracerpython_tpu/kernels/intersect_pallas.py
// _any_hit_call (the pallas_call over _any_hit_kernel_plain /
// _any_hit_kernel_cull, with _mt_rows and _merge_any_tile; under MT_IMPL =
// "plucker" over _any_hit_kernel_plucker_plain / _cull with
// _plucker_block).
//
// A ray is occluded by a valid occluder triangle (pack column 10) with a
// forward hit at t < maxd - 1e-4. Each thread owns one ray; a block of 256
// rays stages the pack in shared memory 256 rows at a time (the tile of
// K1, e1/e2 formed once at load, occluders only) and each thread walks the
// tile as a broadcast read until its first blocking hit. The block stops
// sweeping once no thread has an unoccluded ray left (__syncthreads_or),
// as K2's occluder sweep does. Rays whose window is empty (maxd - 1e-4 <=
// 1e-4: parked lanes, maxd = 0) are never occluded and sweep nothing.
//
// What bounds it on an H100: arithmetic, as for K1 (about 60 flops a
// ray-triangle pair), cut short by the first blocking occluder; the pack
// is re-read from L2 by every block, never the rays.
#include <cuda_runtime.h>

#include "mt.cuh"
#include "plucker.cuh"

namespace {

template <class Form>
__global__ void __launch_bounds__(ptt::kThreads)
any_hit_kernel(const float* __restrict__ o3, const float* __restrict__ d3,
               const float* __restrict__ maxd, int n,
               const float* __restrict__ tripack, int t_count,
               unsigned char* __restrict__ occ_out) {
  __shared__ typename Form::Tile tile;
  const size_t stride = static_cast<size_t>(n);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float md = 0.f;
  if (live) {
    ox = o3[i];
    oy = o3[stride + i];
    oz = o3[2 * stride + i];
    dx = d3[i];
    dy = d3[stride + i];
    dz = d3[2 * stride + i];
    md = maxd[i];
  }
  const typename Form::Ray ray = Form::make_ray(ox, oy, oz, dx, dy, dz);
  const float t_cut = md - ptt::kTMin;
  bool open = live && t_cut > ptt::kTMin;  // not occluded, can still be
  for (int base = 0; base < t_count; base += ptt::kTile) {
    // barrier before the tile is overwritten; the block stops once no
    // thread has an unoccluded ray left
    if (!__syncthreads_or(open)) break;
    const int rows = min(ptt::kTile, t_count - base);
    Form::load(tile, tripack, base, rows, Form::kOccluder);
    __syncthreads();
    for (int j = 0; j < rows && open; ++j) {
      float t;
      if (Form::use(tile, j) && Form::hit(tile, j, ray, t) && t < t_cut)
        open = false;
    }
  }
  if (live) occ_out[i] = !open && t_cut > ptt::kTMin;
}

template <class Form>
int launch_any_hit(const float* o3, const float* d3, const float* maxd, int n,
                   const float* pack, int t_count, unsigned char* occ_out,
                   int device, void* stream) {
  if (n <= 0 || t_count < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (n + ptt::kThreads - 1) / ptt::kThreads;
  any_hit_kernel<Form><<<blocks, ptt::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      o3, d3, maxd, n, pack, t_count, occ_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o3, d3: float32 [3, n] (d3 unit length); maxd: float32 [n];
// tripack: float32 [t_count, 12]; occ_out: bool (one byte) [n]. Launches on
// ``stream`` of CUDA device ``device`` and returns cudaGetLastError() as an
// int (0 = launched).
extern "C" int ptt_any_hit(const float* o3, const float* d3, const float* maxd,
                           int n, const float* tripack, int t_count,
                           unsigned char* occ_out, int device, void* stream) {
  return launch_any_hit<ptt::ClassicForm>(o3, d3, maxd, n, tripack, t_count,
                                          occ_out, device, stream);
}

// The same in the Plücker form; pack36: float32 [t_count, 36], 16-byte
// aligned (kernels/intersect.py: plucker_pack).
extern "C" int ptt_plucker_any_hit(const float* o3, const float* d3,
                                   const float* maxd, int n,
                                   const float* pack36, int t_count,
                                   unsigned char* occ_out, int device,
                                   void* stream) {
  return launch_any_hit<ptt::PluckerForm>(o3, d3, maxd, n, pack36, t_count,
                                          occ_out, device, stream);
}
