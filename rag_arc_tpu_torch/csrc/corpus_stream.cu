// Corpus-stream bandwidth floor for Hopper (sm_90a): one pass over the
// corpus in device memory, reduced so that every byte read is observable.
//
//   out[j, c] = max over rows r with r % 8 == j of (float)x[r, c],
//               starting from -3e38; x (N, d) bf16, f32 or int8; out (8, d).
//
// Replaces the kernel probe's _dma_kernel (tools/kernel_probe.py:194, the
// pallas_call at :238 of its dma_only config): the same stream and the same
// running max, so the probe can tell whether pass 1 of a search is bound by
// memory or by the tensor cores.
//
// What bounds it on an H100: the N*d*elem bytes of the corpus at 3.35 TB/s
// (0.92 ms for 2M x 768 bf16); the max is a few instructions per 16 bytes.
// The design keeps every load 16 bytes wide and in flight:
//   pass 1: a grid-stride loop of 16-byte loads, four independent loads in
//     flight per thread. The total thread count T is a multiple of 8 * V (V
//     16-byte vectors per row), so a thread's vectors all belong to one
//     (r % 8, column group): it keeps its running max in registers and
//     writes it once to a partial row of the scratch (T / (8 V) rows of
//     8 * d floats). No atomics.
//   pass 2: one thread per output element takes the max over the partial
//     rows (a few MB, from L2).
// max is exact in any order, so the result equals its plain version bit
// for bit. The wrapper (ops/corpus_stream.py) requires rows of a multiple
// of 16 bytes starting 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -3.0e38f;
constexpr int THREADS = 256;
constexpr int UNROLL = 4;

enum Dtype { F32 = 0, BF16 = 1, I8 = 2 };

template <int DT>
struct Vec;
template <>
struct Vec<F32> {
  static constexpr int W = 4;
  __device__ static void widen(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};
template <>
struct Vec<BF16> {
  static constexpr int W = 8;
  __device__ static void widen(const uint4& v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);             // low bf16
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);  // high bf16
    }
  }
};
template <>
struct Vec<I8> {
  static constexpr int W = 16;
  __device__ static void widen(const uint4& v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[4 * i + b] = (float)(signed char)((w[i] >> (8 * b)) & 0xffu);
  }
};

template <int DT>
__global__ void __launch_bounds__(THREADS)
stream_kernel(const uint4* __restrict__ x, float* __restrict__ partial,
              long n_vec, int vpr, int d) {
  constexpr int W = Vec<DT>::W;
  const long t = (long)blockIdx.x * THREADS + threadIdx.x;
  const long stride = (long)gridDim.x * THREADS;
  const int period = 8 * vpr;
  const int residue = (int)(t % period);  // which (r % 8, column group)
  float m[W];
#pragma unroll
  for (int e = 0; e < W; ++e) m[e] = NEG;
  long i = t;
  for (; i + (UNROLL - 1) * stride < n_vec; i += UNROLL * stride) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldcs(x + i + u * stride);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float f[W];
      Vec<DT>::widen(v[u], f);
#pragma unroll
      for (int e = 0; e < W; ++e) m[e] = fmaxf(m[e], f[e]);
    }
  }
  for (; i < n_vec; i += stride) {
    float f[W];
    Vec<DT>::widen(__ldcs(x + i), f);
#pragma unroll
    for (int e = 0; e < W; ++e) m[e] = fmaxf(m[e], f[e]);
  }
  const int j = residue / vpr, vc = residue % vpr;
  float* dst = partial + (t / period) * (8L * d) + (long)j * d + (long)vc * W;
#pragma unroll
  for (int e = 0; e < W; ++e) dst[e] = m[e];
}

__global__ void __launch_bounds__(THREADS)
combine_kernel(const float* __restrict__ partial, float* __restrict__ out,
               int rows, int width) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= width) return;
  float m = NEG;
  for (int r = 0; r < rows; ++r) m = fmaxf(m, partial[(long)r * width + c]);
  out[c] = m;
}

}  // namespace

// Partial rows pass 1 writes for a grid of `blocks` blocks (the scratch is
// rows x 8 * d floats).
extern "C" long corpus_stream_partial_rows(int blocks, int d, int elem) {
  const long vpr = (long)d * elem / 16;
  return (long)blocks * THREADS / (8 * vpr);
}

// Blocks for pass 1: about `target` blocks, rounded to a multiple that
// makes the thread count a multiple of 8 * (vectors per row).
extern "C" int corpus_stream_blocks(int d, int elem, int target) {
  const long period = 8L * d * elem / 16;
  long g = period, t = THREADS;  // gcd(period, THREADS)
  while (t) {
    const long r = g % t;
    g = t;
    t = r;
  }
  const long step = period / g;  // blocks * THREADS % period == 0
  long blocks = (target + step - 1) / step * step;
  if (blocks < step) blocks = step;
  return (int)blocks;
}

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16, 2 = int8.
// partial is the scratch of corpus_stream_partial_rows(blocks, d, elem)
// rows of 8 * d floats, blocks from corpus_stream_blocks. The caller
// guarantees a contiguous device corpus whose rows are a multiple of 16
// bytes and start 16-byte aligned. Launches both passes on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int corpus_stream_launch(const void* x, void* partial, void* out,
                                    int N, int d, int dtype, int blocks,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int elem = dtype == F32 ? 4 : (dtype == BF16 ? 2 : 1);
  const int vpr = d * elem / 16;
  if (vpr <= 0 || (long)d * elem % 16 != 0 || blocks <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long n_vec = (long)N * vpr;
  const uint4* xv = static_cast<const uint4*>(x);
  float* p = static_cast<float*>(partial);
  switch (dtype) {
    case F32: stream_kernel<F32><<<blocks, THREADS, 0, s>>>(xv, p, n_vec, vpr, d); break;
    case BF16: stream_kernel<BF16><<<blocks, THREADS, 0, s>>>(xv, p, n_vec, vpr, d); break;
    case I8: stream_kernel<I8><<<blocks, THREADS, 0, s>>>(xv, p, n_vec, vpr, d); break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows = (int)corpus_stream_partial_rows(blocks, d, elem);
  const int width = 8 * d;
  combine_kernel<<<(width + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      p, static_cast<float*>(out), rows, width);
  return (int)cudaGetLastError();
}
