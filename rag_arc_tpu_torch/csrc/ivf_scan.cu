// IVF probe scan for Hopper (sm_90a): the masked scores of every row of
// every list a query probes, each list read where it lies.
//
//   out[b, p * Lmax + r] = valid[c, r] ? score(b, c, r) : -inf,  c = probe[b, p]
//   dot  = sum_i qc[b, i] * x[c, r, i]                 (f32 accumulation)
//   score = dot                                        (cosine / ip)
//         = -((q_sq[b] - 2 dot) + sqnorm[c, r])        (l2)
//         = cross[b, c] + dot * sqnorm[c, r]           (int8 residual codes,
//                                                       sqnorm = row scale)
//
// qc is the query already rounded to the list dtype (bf16 for int8 codes)
// and widened to f32 by the wrapper, so kernel and plain version multiply
// the same values; bf16 and int8 products are exact in f32.
//
// Replaces the probe gather and scoring of rag_arc_tpu/index/ivf.py
// (_ivf_search_body, :768-812; an XLA program, no Pallas). The TPU body
// took care to read the probed lists in place (a vmapped dynamic_slice),
// because an XLA gather staged GBs of copies; in PyTorch `lists[probe]` is
// that copy, a (B, nprobe, Lmax, d) tensor. This kernel keeps the
// property: its only output is the (B, nprobe * Lmax) f32 score buffer.
//
// What bounds it on an H100: bytes. Each (query, probed list) pair reads
// Lmax * d elements for 2 * d operations per row, far below the ~295
// operations a byte where the tensor cores would become the limit. The
// design: one block covers a (query, row tile) of one probed list; it
// holds the query in shared memory, each warp takes a row at a time and
// reads it with 16-byte loads (scalar loads where the rows are not
// 16-byte aligned, and for the tail of a row), reduces with shuffles and
// writes the masked score. Slots that are not valid are not read. Rows
// that several queries probe are read once per query (from L2 when the
// blocks meet there): sharing a list between the queries that probe it,
// and wgmma at large B, are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS_PER_WARP = 8;
constexpr int ROWS = WARPS * ROWS_PER_WARP;  // rows a block covers

enum Dtype { F32 = 0, BF16 = 1, I8 = 2 };
enum Mode { IP = 0, L2 = 1, RESID = 2 };

template <int DT>
struct Elem;
template <>
struct Elem<F32> {
  static constexpr int SIZE = 4;
  static constexpr int W = 4;  // elements in 16 bytes
  __device__ static float load(const char* row, int i) {
    return reinterpret_cast<const float*>(row)[i];
  }
  __device__ static void widen(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};
template <>
struct Elem<BF16> {
  static constexpr int SIZE = 2;
  static constexpr int W = 8;
  __device__ static float load(const char* row, int i) {
    return __uint_as_float((unsigned)reinterpret_cast<const unsigned short*>(row)[i] << 16);
  }
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
struct Elem<I8> {
  static constexpr int SIZE = 1;
  static constexpr int W = 16;
  __device__ static float load(const char* row, int i) {
    return (float)reinterpret_cast<const signed char*>(row)[i];
  }
  __device__ static void widen(const uint4& v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[4 * i + b] = (float)(signed char)((w[i] >> (8 * b)) & 0xffu);
  }
};

template <int DT, int MODE, bool VEC>
__global__ void __launch_bounds__(THREADS)
ivf_scan_kernel(const float* __restrict__ qc, const int64_t* __restrict__ probe,
                const char* __restrict__ lists, long list_stride, long row_stride,
                const float* __restrict__ sqnorm, const uint8_t* __restrict__ valid,
                const float* __restrict__ cross, const float* __restrict__ q_sq,
                float* __restrict__ out, long out_stride, int nprobe, int lmax,
                int d, int nlist, int tiles) {
  extern __shared__ float q_s[];
  using E = Elem<DT>;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int p = blockIdx.y;
  const long c = probe[(long)b * nprobe + p];
  for (int i = threadIdx.x; i < d; i += THREADS) q_s[i] = qc[(long)b * d + i];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* dst = out + (long)b * out_stride + (long)p * lmax;
  const int r0 = tile * ROWS + warp * ROWS_PER_WARP;
  const int r1 = min(r0 + ROWS_PER_WARP, lmax);
  const int n_vec = VEC ? d / E::W : 0;
  for (int r = r0; r < r1; ++r) {
    const long cell = c * lmax + r;
    if (!valid[cell]) {  // warp-uniform: an empty slot is never read
      if (lane == 0) dst[r] = -INFINITY;
      continue;
    }
    const char* row = lists + (c * list_stride + (long)r * row_stride) * E::SIZE;
    float acc = 0.0f;
    if (VEC) {
      const uint4* rv = reinterpret_cast<const uint4*>(row);
#pragma unroll 4
      for (int v = lane; v < n_vec; v += 32) {
        float f[E::W];
        E::widen(__ldg(rv + v), f);
        const float* qv = q_s + v * E::W;
#pragma unroll
        for (int e = 0; e < E::W; ++e) acc = fmaf(f[e], qv[e], acc);
      }
    }
    for (int i = n_vec * E::W + lane; i < d; i += 32) acc = fmaf(E::load(row, i), q_s[i], acc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      float s = acc;
      if (MODE == L2) {
        // -((|q|^2 - 2 dot) + |x|^2), rounded at each step as the plain version
        s = -__fadd_rn(__fsub_rn(q_sq[b], __fmul_rn(2.0f, acc)), sqnorm[cell]);
      } else if (MODE == RESID) {
        s = __fadd_rn(cross[(long)b * nlist + c], __fmul_rn(acc, sqnorm[cell]));
      }
      dst[r] = s;
    }
  }
}

template <int DT, int MODE>
cudaError_t launch_mode(bool vec, dim3 grid, size_t smem, cudaStream_t s,
                        const float* qc, const int64_t* probe, const char* lists,
                        long list_stride, long row_stride, const float* sqnorm,
                        const uint8_t* valid, const float* cross, const float* q_sq,
                        float* out, long out_stride, int nprobe, int lmax, int d,
                        int nlist, int tiles) {
  if (vec) {
    ivf_scan_kernel<DT, MODE, true><<<grid, THREADS, smem, s>>>(
        qc, probe, lists, list_stride, row_stride, sqnorm, valid, cross, q_sq, out,
        out_stride, nprobe, lmax, d, nlist, tiles);
  } else {
    ivf_scan_kernel<DT, MODE, false><<<grid, THREADS, smem, s>>>(
        qc, probe, lists, list_stride, row_stride, sqnorm, valid, cross, q_sq, out,
        out_stride, nprobe, lmax, d, nlist, tiles);
  }
  return cudaGetLastError();
}

template <int DT>
cudaError_t launch_dtype(int mode, bool vec, dim3 grid, size_t smem, cudaStream_t s,
                         const float* qc, const int64_t* probe, const char* lists,
                         long list_stride, long row_stride, const float* sqnorm,
                         const uint8_t* valid, const float* cross, const float* q_sq,
                         float* out, long out_stride, int nprobe, int lmax, int d,
                         int nlist, int tiles) {
  switch (mode) {
    case IP:
      return launch_mode<DT, IP>(vec, grid, smem, s, qc, probe, lists, list_stride,
                                 row_stride, sqnorm, valid, cross, q_sq, out,
                                 out_stride, nprobe, lmax, d, nlist, tiles);
    case L2:
      return launch_mode<DT, L2>(vec, grid, smem, s, qc, probe, lists, list_stride,
                                 row_stride, sqnorm, valid, cross, q_sq, out,
                                 out_stride, nprobe, lmax, d, nlist, tiles);
    case RESID:
      return launch_mode<DT, RESID>(vec, grid, smem, s, qc, probe, lists, list_stride,
                                    row_stride, sqnorm, valid, cross, q_sq, out,
                                    out_stride, nprobe, lmax, d, nlist, tiles);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Rows one block covers (the wrapper's grid arithmetic).
extern "C" int ivf_scan_rows_per_block() { return ROWS; }

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16, 2 = int8;
// mode: 0 = ip, 1 = l2, 2 = int8 residual. lists is (nlist, Lmax, d) with
// element strides list_stride and row_stride and a dense last axis; vec = 1
// when its base and both strides are 16-byte aligned. sqnorm and valid are
// dense (nlist, Lmax); cross is (B, nlist) (mode 2), q_sq is (B,) (mode 1);
// out rows are out_stride floats apart. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int ivf_scan_launch(const void* qc, const void* probe, const void* lists,
                               long list_stride, long row_stride, const void* sqnorm,
                               const void* valid, const void* cross, const void* q_sq,
                               void* out, long out_stride, int B, int nprobe, int lmax,
                               int d, int nlist, int dtype, int mode, int vec,
                               void* stream) {
  if (B <= 0 || nprobe <= 0 || nprobe > 65535 || lmax <= 0 || d <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = (lmax + ROWS - 1) / ROWS;
  if ((long)tiles * B > 2147483647L) return (int)cudaErrorInvalidValue;
  const dim3 grid(tiles * B, nprobe);
  const size_t smem = (size_t)d * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(qc);
  const int64_t* pr = static_cast<const int64_t*>(probe);
  const char* l = static_cast<const char*>(lists);
  const float* sq = static_cast<const float*>(sqnorm);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const float* cr = static_cast<const float*>(cross);
  const float* qs = static_cast<const float*>(q_sq);
  float* o = static_cast<float*>(out);
  switch (dtype) {
    case F32:
      return (int)launch_dtype<F32>(mode, vec, grid, smem, s, q, pr, l, list_stride,
                                    row_stride, sq, v, cr, qs, o, out_stride, nprobe,
                                    lmax, d, nlist, tiles);
    case BF16:
      return (int)launch_dtype<BF16>(mode, vec, grid, smem, s, q, pr, l, list_stride,
                                     row_stride, sq, v, cr, qs, o, out_stride, nprobe,
                                     lmax, d, nlist, tiles);
    case I8:
      return (int)launch_dtype<I8>(mode, vec, grid, smem, s, q, pr, l, list_stride,
                                   row_stride, sq, v, cr, qs, o, out_stride, nprobe,
                                   lmax, d, nlist, tiles);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
