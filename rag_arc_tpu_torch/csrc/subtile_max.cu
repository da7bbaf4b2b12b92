// Sub-tile max producer of the two-level exact top-k, for Hopper (sm_90a).
//
// Computes, for queries q (B, d), corpus x (N, d) (both bf16 or both f32)
// and a row mask valid (N,) uint8:
//
//   out[b, t] = max over r in [t*g, (t+1)*g) of (valid[r] ? q[b].x[r] : NEG)
//
// with the dot product accumulated in f32. out is (B, N/g) f32: the
// select stage reads one query's sub-tile maxima as a contiguous row.
//
// l2 mode (qsq and sqnorm given): each row scores
//   -(qsq[b] - 2 * q[b].x[r] + sqnorm[r])
// before the mask and the max, with qsq the f32 squared norms of the
// queries as passed and sqnorm the corpus's f32 squared norms.
//
// Replaces three TPU kernels of the JAX package:
//   rag_arc_tpu/ops/two_level_stream.py::_stream_kernel (maskless stream)
//   rag_arc_tpu/ops/two_level.py::_subtile_max_kernel_ip (masked grid)
//   rag_arc_tpu/ops/two_level.py::_subtile_max_kernel (l2, masked grid)
// One masked kernel serves all three: the mask costs N bytes against the
// corpus's 2*N*d, and it makes the result exact without the TPU path's
// positive-kth certificate. The l2 epilogue reads 4 more bytes per row.
//
// What bounds it on an H100: 2*B*N*d FLOPs against N*d*2 bytes of corpus
// (bf16), i.e. B operations per byte. The card needs ~295 operations per
// byte before the tensor cores, not HBM, are the limit, so the kernel is
// compute-bound at B = 512 and byte-bound at small B. This first version
// is simple: WMMA m16n16k16 fragments fed from shared memory loaded by
// plain 16-byte loads. Queries are the fast grid axis, so the blocks in
// flight share corpus rows and the corpus is read from HBM about once
// (the whole query block stays in L2). TMA loads, wgmma and a persistent
// pipelined schedule are later work.
//
// The f32 path uses CUDA-core FMAs in the same block tiling; TF32 would
// change rankings against the f32 reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr float NEG = -3.0e38f;  // sentinel below any real score
constexpr int THREADS = 256;     // 8 warps
constexpr int ROWS = 128;        // corpus rows per block: 8 warps x 16
constexpr int FRAG = 16;         // WMMA tile edge; one warp owns 16 rows

// ---------------------------------------------------------------- bf16 --

// d-slice staged in shared memory per step, and its padded row length in
// bf16 elements (80 bytes: 16-byte stores and 32-byte WMMA loads stay
// aligned). Static shared memory: 2 x 10 KB tiles + 8 KB stage + 4 KB.
constexpr int KT = 32;
constexpr int LDS = KT + 8;

// Copies 8 bf16 values of row `src` starting at column k into dst, with
// zeros past d or for a row outside the matrix.
__device__ __forceinline__ void load8_bf16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int k,
                                           int d, bool row_ok, bool vec) {
  if (row_ok && vec && k + 8 <= d) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src + k);
    return;
  }
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    dst[i] = (row_ok && k + i < d) ? src[k + i] : zero;
  }
}

// True when every row of a (rows, d) bf16 matrix at p starts on a 16-byte
// boundary, so 8 elements at a time load as one uint4.
__device__ __forceinline__ bool rows_16b_aligned(const __nv_bfloat16* p,
                                                 int d) {
  return (d % 8) == 0 && (reinterpret_cast<uintptr_t>(p) % 16) == 0;
}

// QF query fragments per warp: a block covers ROWS corpus rows x QB
// queries.
constexpr int QF = 8;
constexpr int QB = FRAG * QF;

// The l2 score of a row from its dot product (L2) or the dot itself.
template <bool L2>
__device__ __forceinline__ float row_score(float dot, float qsq, float sqn) {
  return L2 ? -((qsq - 2.0f * dot) + sqn) : dot;
}

template <bool L2>
__global__ void __launch_bounds__(THREADS)
subtile_max_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ x,
                        const uint8_t* __restrict__ valid,
                        const float* __restrict__ qsq,
                        const float* __restrict__ sqnorm,
                        float* __restrict__ out, int B, int N, int d, int g) {
  constexpr int WARPS = THREADS / 32;
  __shared__ __align__(32) __nv_bfloat16 xs[ROWS * LDS];
  __shared__ __align__(32) __nv_bfloat16 qs[QB * LDS];
  __shared__ __align__(32) float stage[WARPS][FRAG * FRAG];
  __shared__ float maxes[QB][WARPS];  // 16-row maxima per query

  const int n_qblk = (B + QB - 1) / QB;
  const int b0 = (blockIdx.x % n_qblk) * QB;
  const long r0 = (long)(blockIdx.x / n_qblk) * ROWS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // a view with a storage offset may start off a 16-byte boundary: it
  // takes the element-wise loads
  const bool x_vec = rows_16b_aligned(x, d);
  const bool q_vec = rows_16b_aligned(q, d);

  wmma::fragment<wmma::accumulator, FRAG, FRAG, FRAG, float> acc[QF];
#pragma unroll
  for (int j = 0; j < QF; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int k0 = 0; k0 < d; k0 += KT) {
    for (int c = threadIdx.x; c < ROWS * (KT / 8); c += THREADS) {
      const int r = c / (KT / 8);
      const int kk = (c % (KT / 8)) * 8;
      const long row = r0 + r;
      load8_bf16(xs + r * LDS + kk, x + row * d, k0 + kk, d, row < N, x_vec);
    }
    for (int c = threadIdx.x; c < QB * (KT / 8); c += THREADS) {
      const int r = c / (KT / 8);
      const int kk = (c % (KT / 8)) * 8;
      const long qrow = b0 + r;
      load8_bf16(qs + r * LDS + kk, q + qrow * d, k0 + kk, d, qrow < B, q_vec);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT; kk += FRAG) {
      wmma::fragment<wmma::matrix_a, FRAG, FRAG, FRAG, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, xs + warp * FRAG * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < QF; ++j) {
        // q rows are the columns of B = qᵀ: column-major with stride LDS
        wmma::fragment<wmma::matrix_b, FRAG, FRAG, FRAG, __nv_bfloat16,
                       wmma::col_major> bq;
        wmma::load_matrix_sync(bq, qs + j * FRAG * LDS + kk, LDS);
        wmma::mma_sync(acc[j], a, bq, acc[j]);
      }
    }
    __syncthreads();
  }

  // epilogue: each warp reduces its 16 rows (scores[row][query]) to one
  // masked max per query, one fragment at a time through shared memory
  const long wrow = r0 + warp * FRAG;
  float* st = stage[warp];
#pragma unroll
  for (int j = 0; j < QF; ++j) {
    wmma::store_matrix_sync(st, acc[j], FRAG, wmma::mem_row_major);
    __syncwarp();
    if (lane < FRAG) {
      const int bq = b0 + j * FRAG + lane;
      const float q2 = (L2 && bq < B) ? qsq[bq] : 0.0f;
      float m = NEG;
      for (int r = 0; r < FRAG; ++r) {
        const long row = wrow + r;
        if (row < N && valid[row]) {
          const float sq = L2 ? sqnorm[row] : 0.0f;
          m = fmaxf(m, row_score<L2>(st[r * FRAG + lane], q2, sq));
        }
      }
      maxes[j * FRAG + lane][warp] = m;
    }
    __syncwarp();
  }
  __syncthreads();

  // g = 16*m rows per sub-tile: combine m neighbouring 16-row maxima;
  // consecutive threads write consecutive sub-tiles of one query
  const int per = g / FRAG;
  const int n_out = ROWS / g;
  const long n_sub = N / g;
  const long t0 = r0 / g;
  for (int i = threadIdx.x; i < QB * n_out; i += THREADS) {
    const int bq = i / n_out;
    const int w = i % n_out;
    const long t = t0 + w;
    if (b0 + bq >= B || t >= n_sub) continue;
    float m = NEG;
    for (int p = 0; p < per; ++p) m = fmaxf(m, maxes[bq][w * per + p]);
    out[(long)(b0 + bq) * n_sub + t] = m;
  }
}

// ----------------------------------------------------------------- f32 --

constexpr int FQB = 32;  // queries per block
constexpr int FKT = 32;  // d-slice per step

// 256 threads, each owning 4 rows x 4 queries of the 128 x 32 block.
template <bool L2>
__global__ void __launch_bounds__(THREADS)
subtile_max_f32_kernel(const float* __restrict__ q, const float* __restrict__ x,
                       const uint8_t* __restrict__ valid,
                       const float* __restrict__ qsq,
                       const float* __restrict__ sqnorm,
                       float* __restrict__ out, int B, int N, int d, int g) {
  __shared__ float xs[FKT][ROWS + 4];  // k-major: rows contiguous
  __shared__ float qs[FKT][FQB + 4];
  __shared__ float ss[ROWS][FQB + 1];

  const int n_qblk = (B + FQB - 1) / FQB;
  const int b0 = (blockIdx.x % n_qblk) * FQB;
  const long r0 = (long)(blockIdx.x / n_qblk) * ROWS;
  const int tq = threadIdx.x % 8;  // queries tq*4 .. tq*4+3
  const int tr = threadIdx.x / 8;  // rows tr*4 .. tr*4+3

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += FKT) {
    for (int c = threadIdx.x; c < ROWS * FKT; c += THREADS) {
      const int r = c / FKT;
      const int kk = c % FKT;
      const long row = r0 + r;
      xs[kk][r] = (row < N && k0 + kk < d) ? x[row * d + k0 + kk] : 0.0f;
    }
    for (int c = threadIdx.x; c < FQB * FKT; c += THREADS) {
      const int r = c / FKT;
      const int kk = c % FKT;
      const long qrow = b0 + r;
      qs[kk][r] = (qrow < B && k0 + kk < d) ? q[qrow * d + k0 + kk] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FKT; ++kk) {
      float xr[4], qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xr[i] = xs[kk][tr * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) qv[j] = qs[kk][tq * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xr[i], qv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) ss[tr * 4 + i][tq * 4 + j] = acc[i][j];
  __syncthreads();

  const int n_out = ROWS / g;
  const long n_sub = N / g;
  const long t0 = r0 / g;
  for (int i = threadIdx.x; i < FQB * n_out; i += THREADS) {
    const int bq = i / n_out;
    const int w = i % n_out;
    const long t = t0 + w;
    if (b0 + bq >= B || t >= n_sub) continue;
    const float q2 = L2 ? qsq[b0 + bq] : 0.0f;
    float m = NEG;
    for (int r = 0; r < g; ++r) {
      const long row = r0 + (long)w * g + r;
      if (valid[row]) {
        const float sq = L2 ? sqnorm[row] : 0.0f;
        m = fmaxf(m, row_score<L2>(ss[w * g + r][bq], q2, sq));
      }
    }
    out[(long)(b0 + bq) * n_sub + t] = m;
  }
}

template <bool L2>
int launch(const void* q, const void* x, const uint8_t* v, const float* qsq,
           const float* sqn, float* o, int B, int N, int d, int g, int dtype,
           cudaStream_t s) {
  const long row_blocks = ((long)N + ROWS - 1) / ROWS;
  if (dtype == 1) {
    const long blocks = row_blocks * ((B + QB - 1) / QB);
    subtile_max_bf16_kernel<L2><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(x), v, qsq, sqn, o, B, N, d, g);
  } else if (dtype == 0) {
    const long blocks = row_blocks * ((B + FQB - 1) / FQB);
    subtile_max_f32_kernel<L2><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(x), v, qsq,
        sqn, o, B, N, d, g);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16. qsq (B,)
// and sqnorm (N,) f32 select the l2 mode; both null for cosine/ip. The
// caller guarantees contiguous device buffers, N % g == 0 and g in
// {16, 32, 64, 128}. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 on success).
extern "C" int subtile_max_launch(const void* q, const void* x,
                                  const void* valid, const void* qsq,
                                  const void* sqnorm, void* out, int B, int N,
                                  int d, int g, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(out);
  const float* qs = static_cast<const float*>(qsq);
  const float* sq = static_cast<const float*>(sqnorm);
  if ((qs == nullptr) != (sq == nullptr)) return (int)cudaErrorInvalidValue;
  if (qs != nullptr) return launch<true>(q, x, v, qs, sq, o, B, N, d, g, dtype, s);
  return launch<false>(q, x, v, qs, sq, o, B, N, d, g, dtype, s);
}
