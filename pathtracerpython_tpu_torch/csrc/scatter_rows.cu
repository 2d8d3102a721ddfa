// scatter_rows: the adjoint of a row gather. values [N, C] summed into
// rows[i] of a zero [n_rows, C] table, in an order fixed by the inputs
// alone, so that the same inputs give the same bits on every launch, stream
// and run. Every table gradient of the port goes through it (ops/gather.py:
// the backwards of the nearest sweeps, of the fused NEE and of cm_take /
// take_rows).
//
// Replaces no TPU kernel: the JAX package's table gradients are XLA's
// scatter-add, the transpose of a gather (pathtracerpython_tpu/ops/
// gather.py:50 take_rows; the jax.vjp of the sweeps' gathers in
// kernels/intersect_pallas.py:512-528 _nearest_bwd and kernels/
// nee_pallas.py:315-325 _nee_vjp_bwd), which XLA sums in a fixed order. On
// the card PyTorch's own candidates, a weighted bincount and index_add_,
// add with float atomics, whose order (and so whose last bits) follows the
// schedule; the weighted bincount also reads its bins' range back to the
// host.
//
// Bound: bytes. The function reads each lane's C floats and its row once and
// writes the table once (~44 bytes a lane at C = 9 with int64 rows). Every
// table of a training step is narrow (at most 64 rows x 9), so the design
// splits on the table's size S = n_rows * C, which with N alone fixes the
// path and every grid (no host read, no atomics):
//
// Narrow, S <= kNarrowSlots: no sort. The lanes fall in rounds of kThreads;
// at most kGrid blocks each take a contiguous run of rpb rounds (rpb =
// ceil(rounds / kGrid), then blocks = ceil(rounds / rpb)), thread t of a
// block lane t of each of its rounds. Every lane's key and values are read
// once, in the caller's layout (a component-major [N, C] view column by
// column, each column's loads coalesced), kBatch rounds' loads issued before
// their adds.
//  - Tiny, S <= kTinySlots (the light table, 2 x 9; mat_rgb, 8 x 3): each
//    thread owns S accumulators in shared memory (slot s of thread t at
//    s * kThreads + t, one bank a thread) and adds its lanes into them
//    serially, in lane order. Then for each slot a shuffle-down tree over
//    the warp and a halving tree over the block's 8 warps.
//  - Otherwise (the triangle pack, 64 x 9): each warp owns a table of S
//    floats in shared memory. Its 32 lanes of a round group by key with
//    __match_any_sync and stage their values; within a group, the lane of
//    rank p adds columns p, p + size, ... of every member, in lane order,
//    into the warp's table, so an entry has one writer a round and takes
//    the warp's lanes serially, in lane order. Then a halving tree over the
//    block's 8 warps.
//  Each block writes its S partials to part[s * blocks + block]; a second
//  launch (grid_tree_kernel) gives each entry one warp: lane j adds the
//  partials of blocks j, j + 32, ... serially, then a shuffle-down tree.
//  The sort, the permutation gather, a row-major copy and an [N, C] scratch
//  are all gone from this path.
//
// Wide, S > kNarrowSlots (the 100k field's 100,096 rows, a few lanes each):
// the wrapper sorts the rows stably (torch.sort(stable=True) of int32 keys:
// a permutation fixed by the rows, a row's lanes in ascending lane order).
// windows_kernel: one warp a window of 32 sorted positions, lane l position
// 32 w + l, its values read through the permutation (every lane's loads in
// flight at once); an inclusive segmented scan over the window's runs of
// equal keys (Hillis-Steele, offsets 1 to 16). A run whose row starts and
// ends inside the window is the row's sum and is written to the table; a
// row that crosses a window's edge leaves the sum of its run at the window's
// head (part[w][0]) or tail (part[w][1]), and the window where it ends
// writes its end (row_end[row]). rows_kernel: the window where such a row
// starts owns it; its warp sums the row's partials, P0 = the tail of the
// first window and Pi = the head of window w + i: lane j adds P_j, P_j+32,
// ... serially (kBatch of them loaded together), then a shuffle-down tree.
// The table is zeroed first (rows with no lane). Of the old design the
// row-major copy and the [N, C] scratch are gone; the scratch is 2 x C
// floats a window and an end a row.
//
// ops/gather.py:scatter_rows_model repeats every one of these orders in
// plain PyTorch, bit for bit; the card's checks hold the kernel to it.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // a block: 8 warps; a round: 256 lanes
constexpr int kWarps = kThreads / 32;
constexpr int kGrid = 528;          // narrow blocks at most: 4 on each of 132 SMs
constexpr int kTinySlots = 32;      // up to here a thread's own accumulators
constexpr int kNarrowSlots = 1024;  // up to here a warp's own table
constexpr int kWindow = 32;         // wide: sorted positions a warp sums
constexpr int kMaxCols = 16;        // columns a lane carries at once
constexpr int kBatch = 2;           // rounds whose loads are issued together
constexpr int kStage = 33;          // a staged column, padded off the banks

// lane 0 ends with the sum of the warp's 32 values, in a fixed tree
__device__ __forceinline__ float warp_tree(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// the sum of the block's kWarps values x[w * stride], halving: x[i] + x[i + h]
__device__ __forceinline__ float warps_tree(const float* x, int stride) {
  float v[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v[w] = x[w * stride];
#pragma unroll
  for (int h = kWarps / 2; h > 0; h >>= 1) {
#pragma unroll
    for (int i = 0; i < h; ++i) v[i] = v[i] + v[i + h];
  }
  return v[0];
}

// a lane's key if it is a row of the table, else -1 (summed nowhere)
template <typename K>
__device__ __forceinline__ int table_key(const K* rows, long long lane,
                                         long long end, int n_rows) {
  if (lane >= end) return -1;
  const K r = rows[lane];
  return r >= 0 && r < n_rows ? static_cast<int>(r) : -1;
}

template <typename K>
__global__ void __launch_bounds__(kThreads, 4)
tiny_kernel(const float* __restrict__ values, long long sn, long long sc,
            long long n, int c, const K* __restrict__ rows, int n_rows,
            long long rpb, float* __restrict__ part) {
  __shared__ float acc[kTinySlots * kThreads];
  __shared__ float sums[kTinySlots * kWarps];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int slots = n_rows * c;
  for (int s = 0; s < slots; ++s) acc[s * kThreads + t] = 0.0f;
  const long long first = static_cast<long long>(blockIdx.x) * rpb *
                          kThreads;
  const long long end = min(first + rpb * kThreads, n);
  for (long long base = first + t; base - t < end;
       base += kBatch * kThreads) {
    int key[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q)
      key[q] = table_key(rows, base + q * kThreads, end, n_rows);
    for (int c0 = 0; c0 < c; c0 += kMaxCols) {
      const int nc = min(kMaxCols, c - c0);
      float v[kBatch][kMaxCols];
      // every live lane's values, whatever its key, so that the loads do
      // not wait for the keys
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const bool live = base + q * kThreads < end;
        const float* src = values + (base + q * kThreads) * sn + c0 * sc;
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j)
          v[q][j] = live && j < nc ? src[j * sc] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (key[q] < 0) continue;
        float* dst = acc + (key[q] * c + c0) * kThreads + t;
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j)
          if (j < nc) dst[j * kThreads] += v[q][j];
      }
    }
  }
  for (int s = 0; s < slots; ++s) {
    const float x = warp_tree(acc[s * kThreads + t]);
    if (lane == 0) sums[s * kWarps + warp] = x;
  }
  __syncthreads();
  if (t < slots)
    part[static_cast<long long>(t) * gridDim.x + blockIdx.x] =
        warps_tree(sums + t * kWarps, 1);
}

template <typename K>
__global__ void __launch_bounds__(kThreads, 4)
narrow_kernel(const float* __restrict__ values, long long sn, long long sc,
              long long n, int c, const K* __restrict__ rows, int n_rows,
              long long rpb, float* __restrict__ part) {
  extern __shared__ float smem[];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int slots = n_rows * c;
  float* table = smem + warp * slots;
  float* stage = smem + kWarps * slots + warp * kMaxCols * kStage;
  for (int e = lane; e < slots; e += 32) table[e] = 0.0f;
  __syncwarp();
  const long long first = static_cast<long long>(blockIdx.x) * rpb *
                          kThreads;
  const long long end = min(first + rpb * kThreads, n);
  const unsigned below = (1u << lane) - 1u;
  for (long long step = first + warp * 32; step < end;
       step += kBatch * kThreads) {
    int key[kBatch];
    unsigned peers[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      key[q] = table_key(rows, step + q * kThreads + lane, end, n_rows);
      peers[q] = __match_any_sync(0xffffffffu, key[q]);
    }
    for (int c0 = 0; c0 < c; c0 += kMaxCols) {
      const int nc = min(kMaxCols, c - c0);
      float v[kBatch][kMaxCols];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const bool live = step + q * kThreads + lane < end;
        const float* src = values + (step + q * kThreads + lane) * sn +
                           c0 * sc;
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j)
          v[q][j] = live && j < nc ? src[j * sc] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j)
          if (j < nc) stage[j * kStage + lane] = v[q][j];
        __syncwarp();
        if (key[q] >= 0) {
          const int size = __popc(peers[q]);
          float* dst = table + key[q] * c + c0;
          for (int j = __popc(peers[q] & below); j < nc; j += size) {
            float a = dst[j];
            for (unsigned m = peers[q]; m; m &= m - 1u)
              a += stage[j * kStage + __ffs(m) - 1];
            dst[j] = a;
          }
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  for (int e = t; e < slots; e += kThreads)
    part[static_cast<long long>(e) * gridDim.x + blockIdx.x] =
        warps_tree(smem + e, slots);
}

// one warp an entry of the table: the blocks' partials, lane j those of
// blocks j, j + 32, ... serially, then the warp's tree
__global__ void __launch_bounds__(kThreads)
grid_tree_kernel(const float* __restrict__ part, int blocks, int slots,
                 float* __restrict__ out) {
  const int e = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= slots) return;
  const float* src = part + static_cast<long long>(e) * blocks;
  float s = 0.0f;
  for (int b = lane; b < blocks; b += 32) s += src[b];
  s = warp_tree(s);
  if (lane == 0) out[e] = s;
}

__global__ void __launch_bounds__(kThreads)
windows_kernel(const float* __restrict__ values, long long sn, long long sc,
               long long n, int c, const int* __restrict__ keys,
               const long long* __restrict__ perm, int n_rows,
               float* __restrict__ part, long long* __restrict__ row_end,
               float* __restrict__ out) {
  const long long w = static_cast<long long>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const long long p0 = w * kWindow;
  if (p0 >= n) return;
  const long long p = p0 + lane;
  const int k = p < n ? keys[p] : INT_MIN;
  const bool in_table = p < n && k >= 0 && k < n_rows;
  const int prev = __shfl_up_sync(0xffffffffu, k, 1);
  const int next = __shfl_down_sync(0xffffffffu, k, 1);
  // the window's runs: the lane where each lane's run begins, and whether
  // it ends here; the window's first run may have begun in the window
  // before, its last may go on into the next
  const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || k != prev);
  const unsigned upto = lane == 31 ? 0xffffffffu : (2u << lane) - 1u;
  const int head = 31 - __clz(heads & upto);
  const bool run_end = lane == 31 || k != next;
  const int k0 = __shfl_sync(0xffffffffu, k, 0);
  const bool starts0 = p0 == 0 || keys[p0 - 1] != k0;
  const bool goes_on = lane == 31 && p + 1 < n && keys[p + 1] == k;
  const bool whole = (head > 0 || starts0) && !goes_on;
  // every lane's values, whatever its key (a run outside the table is
  // written nowhere), so that the loads wait for the permutation alone
  const long long src_row = p < n ? perm[p] : 0;
  for (int c0 = 0; c0 < c; c0 += kMaxCols) {
    const int nc = min(kMaxCols, c - c0);
    float x[kMaxCols];
    const float* src = values + src_row * sn + c0 * sc;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
      x[j] = p < n && j < nc ? src[j * sc] : 0.0f;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      if (j >= nc) break;  // nc is the warp's: the shuffles stay converged
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, x[j], off);
        if (lane - off >= head) x[j] = y + x[j];
      }
    }
    if (!in_table || !run_end) continue;
    if (c0 == 0 && head == 0 && !starts0 && !goes_on)
      row_end[k] = p + 1;  // a row from an earlier window ends here
    if (whole) {
      float* dst = out + static_cast<long long>(k) * c + c0;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        if (j < nc) dst[j] = x[j];
      continue;
    }
    if (head == 0) {
      float* dst = part + (w * 2) * c + c0;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        if (j < nc) dst[j] = x[j];
    }
    if (lane == 31) {
      float* dst = part + (w * 2 + 1) * c + c0;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        if (j < nc) dst[j] = x[j];
    }
  }
}

// one warp a window: if a row starts in window w and goes on past it, its
// sum from the windows' partials
__global__ void __launch_bounds__(kThreads)
rows_kernel(long long n, int c, const int* __restrict__ keys, int n_rows,
            const float* __restrict__ part,
            const long long* __restrict__ row_end, float* __restrict__ out) {
  const long long w = static_cast<long long>(blockIdx.x) * kWarps +
                      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  const long long p0 = w * kWindow;
  const long long next = p0 + kWindow;
  if (next >= n) return;
  const int k = keys[next - 1];
  if (k < 0 || k >= n_rows || keys[next] != k) return;
  if (p0 > 0 && keys[p0] == k && keys[p0 - 1] == k) return;  // began before
  const long long m = (row_end[k] - 1) / kWindow - w + 1;  // its partials
  for (int c0 = 0; c0 < c; c0 += kMaxCols) {
    const int nc = min(kMaxCols, c - c0);
    float s[kMaxCols];
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) s[j] = 0.0f;
    for (long long i0 = lane; i0 < m; i0 += kBatch * 32) {
      float x[kBatch][kMaxCols];
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        const long long i = i0 + q * 32;
        const float* src = part + ((w + i) * 2 + (i == 0 ? 1 : 0)) * c + c0;
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j)
          x[q][j] = i < m && j < nc ? src[j] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kBatch; ++q) {
        if (i0 + q * 32 >= m) break;
#pragma unroll
        for (int j = 0; j < kMaxCols; ++j)
          if (j < nc) s[j] += x[q][j];
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      if (j >= nc) break;
      s[j] = warp_tree(s[j]);
    }
    if (lane == 0) {
      float* dst = out + static_cast<long long>(k) * c + c0;
#pragma unroll
      for (int j = 0; j < kMaxCols; ++j)
        if (j < nc) dst[j] = s[j];
    }
  }
}

template <typename K>
cudaError_t launch_narrow(const float* values, long long sn, long long sc,
                          long long n, int c, const K* rows, int n_rows,
                          long long rpb, int blocks, float* part,
                          cudaStream_t s) {
  const int slots = n_rows * c;
  if (slots <= kTinySlots) {
    tiny_kernel<K><<<blocks, kThreads, 0, s>>>(values, sn, sc, n, c, rows,
                                               n_rows, rpb, part);
    return cudaGetLastError();
  }
  const size_t bytes = sizeof(float) * (static_cast<size_t>(kWarps) * slots +
                                        kWarps * kMaxCols * kStage);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        narrow_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
  }
  narrow_kernel<K><<<blocks, kThreads, bytes, s>>>(values, sn, sc, n, c, rows,
                                                  n_rows, rpb, part);
  return cudaGetLastError();
}

}  // namespace

// values: float32 [n, c] at element strides (sn, sc); rows: [n] integers of
// row_bytes (4 or 8) bytes each, read by the narrow path; keys: int32 [n],
// the rows sorted stably, and perm: int64 [n], the sort's permutation
// (keys[p] = rows[perm[p]]), read by the wide path (null on the narrow);
// part: float32 scratch of part_len floats (narrow: n_rows * c * blocks;
// wide: 2 * c * ceil(n / 32)); row_end: int64 [n_rows] scratch of the wide
// path (null on the narrow); out: float32 [n_rows, c], every entry
// written. n >= 1, c >= 1, n_rows >= 1; n_rows * c < 2^31. Launches on
// ``stream`` of CUDA device ``device`` and returns the first CUDA error as
// an int (0 = launched).
extern "C" int ptt_scatter_rows(const float* values, long long sn,
                                long long sc, long long n, int c,
                                const void* rows, int row_bytes,
                                const int* keys, const long long* perm,
                                int n_rows, float* part, long long part_len,
                                long long* row_end, float* out, int device,
                                void* stream) {
  if (n < 1 || c < 1 || n_rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long slots = static_cast<long long>(n_rows) * c;
  if (slots <= kNarrowSlots) {
    const long long rounds = (n + kThreads - 1) / kThreads;
    const long long rpb = (rounds + kGrid - 1) / kGrid;
    const int blocks = static_cast<int>((rounds + rpb - 1) / rpb);
    if (rows == nullptr || part_len < slots * blocks)
      return static_cast<int>(cudaErrorInvalidValue);
    if (row_bytes == 8)
      err = launch_narrow(values, sn, sc, n, c,
                          static_cast<const long long*>(rows), n_rows, rpb,
                          blocks, part, s);
    else if (row_bytes == 4)
      err = launch_narrow(values, sn, sc, n, c, static_cast<const int*>(rows),
                          n_rows, rpb, blocks, part, s);
    else
      err = cudaErrorInvalidValue;
    if (err != cudaSuccess) return static_cast<int>(err);
    grid_tree_kernel<<<static_cast<unsigned>((slots + kWarps - 1) / kWarps),
                       kThreads, 0, s>>>(part, blocks,
                                         static_cast<int>(slots), out);
    return static_cast<int>(cudaGetLastError());
  }
  const long long windows = (n + kWindow - 1) / kWindow;
  if (keys == nullptr || perm == nullptr || row_end == nullptr ||
      part_len < 2 * c * windows)
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaMemsetAsync(out, 0, sizeof(float) * static_cast<size_t>(slots), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = static_cast<unsigned>((windows + kWarps - 1) /
                                              kWarps);
  windows_kernel<<<grid, kThreads, 0, s>>>(values, sn, sc, n, c, keys, perm,
                                           n_rows, part, row_end, out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rows_kernel<<<grid, kThreads, 0, s>>>(n, c, keys, n_rows, part, row_end,
                                        out);
  return static_cast<int>(cudaGetLastError());
}
