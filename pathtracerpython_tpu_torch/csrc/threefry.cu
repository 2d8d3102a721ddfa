// threefry: the port's random draws. ops/rng.py:uniforms(k0, k1, counters,
// n_draws) on the card: for counter c (its low 32 bits) and hash j, the
// pair threefry2x32(key, (c, j)) with the standard 20 rounds, its two words
// draws 2j and 2j + 1 in [0, 1). Bit for bit the plain version
// (ops/rng.py:uniforms_plain), which is the JAX package's jax.random
// layout: Threefry and the unit-interval map are exact integer and exact
// float operations.
//
// Replaces no TPU kernel: the JAX package's ops/rng.py is plain jnp, which
// XLA fuses. The plain PyTorch version runs the hash as int64 tensor ops,
// PyTorch having no shifts on uint32, every word masked after each step:
// about 170 elementwise launches a hash, each reading and writing the
// lanes' int64 words in device memory.
//
// Bound: integer operations and bytes, close together. A hash is about 72
// uint32 operations (the 2 initial key adds, 20 rounds of an add, a funnel
// shift and an xor, 5 key injections of 2 adds); a draw's conversion a
// shift, an or and a float subtract. For 15 draws over 4,194,304 counters
// that is ~2.6 G operations: 0.078 ms at the card's dispatch ceiling (4 warp
// instructions a clock an SM, 33.5 T lanes a second; the adds run as IMAD
// on the float pipe beside the integer pipe's shifts and logic), 0.156 ms
// if only the 64 INT32 lanes an SM took them. The bytes are each counter
// read once (8 bytes as int64) and each float32 draw written once: 285 MB,
// 0.085 ms at 3.35 TB/s.
//
// Design: one thread a counter, walked in a grid-stride loop; the counter
// is read once, every hash of it runs in registers (the rotations unrolled
// at compile time, the key schedule computed once a thread), and each draw
// is written once, to out[d * n + i], so a warp's stores of one draw row
// are coalesced. Offsets are 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // a full wave of 256-thread blocks
constexpr uint32_t kParity = 0x1BD11BDAu;

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;  // rotate left by r
}

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds(uint32_t& x0, uint32_t& x1) {
  mix(x0, x1, R0);
  mix(x0, x1, R1);
  mix(x0, x1, R2);
  mix(x0, x1, R3);
}

// ks: the key words and their parity; the injections add block + 1 to the
// second word, folded into ksb[block]
struct Schedule {
  uint32_t ks[3];
  uint32_t ksb[5];
};

__device__ __forceinline__ Schedule schedule(uint32_t k0, uint32_t k1) {
  Schedule s;
  s.ks[0] = k0;
  s.ks[1] = k1;
  s.ks[2] = k0 ^ k1 ^ kParity;
#pragma unroll
  for (int b = 0; b < 5; ++b) s.ksb[b] = s.ks[(b + 2) % 3] + (b + 1);
  return s;
}

__device__ __forceinline__ void threefry(const Schedule& s, uint32_t& x0,
                                         uint32_t& x1) {
  x0 += s.ks[0];
  x1 += s.ks[1];
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += s.ks[1];
  x1 += s.ksb[0];
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += s.ks[2];
  x1 += s.ksb[1];
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += s.ks[0];
  x1 += s.ksb[2];
  rounds<17, 29, 16, 24>(x0, x1);
  x0 += s.ks[1];
  x1 += s.ksb[3];
  rounds<13, 15, 26, 6>(x0, x1);
  x0 += s.ks[2];
  x1 += s.ksb[4];
}

// a word -> float32 in [0, 1): 23 bits under the exponent of 1, less 1
__device__ __forceinline__ float unit(uint32_t y) {
  return __uint_as_float((y >> 9) | 0x3F800000u) - 1.0f;
}

template <typename Counter>
__global__ void __launch_bounds__(kThreads)
threefry_uniforms_kernel(const Counter* __restrict__ counters,
                         long long stride, long long n, int n_draws,
                         uint32_t k0, uint32_t k1, float* __restrict__ out) {
  const Schedule s = schedule(k0, k1);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    const uint32_t c = static_cast<uint32_t>(counters[i * stride]);
    float* o = out + i;
    for (int d = 0; d < n_draws; d += 2) {
      uint32_t x0 = c, x1 = static_cast<uint32_t>(d >> 1);
      threefry(s, x0, x1);
      o[static_cast<long long>(d) * n] = unit(x0);
      if (d + 1 < n_draws) o[static_cast<long long>(d + 1) * n] = unit(x1);
    }
  }
}

template <typename Counter>
cudaError_t launch(const void* counters, long long stride, long long n,
                   int n_draws, uint32_t k0, uint32_t k1, float* out,
                   cudaStream_t s) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  const unsigned grid =
      static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  threefry_uniforms_kernel<Counter><<<grid, kThreads, 0, s>>>(
      static_cast<const Counter*>(counters), stride, n, n_draws, k0, k1, out);
  return cudaGetLastError();
}

}  // namespace

// counters: [n] integers of counter_bytes (4 or 8) bytes at element stride
// ``stride``, their low 32 bits the counter words; out: float32 [n_draws,
// n], every entry written. n >= 1, n_draws >= 1. Launches on ``stream`` of
// CUDA device ``device`` and returns the first CUDA error as an int (0 =
// launched).
extern "C" int ptt_threefry_uniforms(const void* counters, long long stride,
                                     int counter_bytes, long long n,
                                     int n_draws, unsigned k0, unsigned k1,
                                     float* out, int device, void* stream) {
  if (n < 1 || n_draws < 1 || counters == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (counter_bytes == 8)
    err = launch<long long>(counters, stride, n, n_draws, k0, k1, out, s);
  else if (counter_bytes == 4)
    err = launch<int>(counters, stride, n, n_draws, k0, k1, out, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
