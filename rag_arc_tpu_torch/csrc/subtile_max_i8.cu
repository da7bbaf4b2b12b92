// Int8 sub-tile max producer of the quantized two-level exact top-k, for
// Hopper (sm_90a).
//
// For int8 query codes q (B, d), int8 corpus codes x (N, d), f32 row
// scales scale (N,) and a row mask valid (N,) uint8, the dot q[b].x[r] is
// an int8 x int8 -> int32 product on the tensor cores (IMMA), and
//
//   block mode: out[b, t] = scale[t*g] * max over live r in sub-tile t of
//               the raw int32 dot, or NEG when no row is live. Every row
//               of a sub-tile shares one scale (the flat index's
//               QUANT_BLOCK storage), so max(s*x) = s*max(x);
//   row mode:   out[b, t] = max over live r of (float)dot * scale[r], or
//               NEG when no row is live.
//
// Dead rows take the sentinel -2^30 on the raw int32, which no real dot
// reaches (|dot| <= d*127^2 < 2^24 for d <= 1040); a max at or below
// -2^29 means an all-dead sub-tile. Every step is exact: the int32 dot,
// its conversion to f32 (exact below 2^24), one f32 multiply. So the
// kernel equals its plain version (ops/subtile_max_i8.py) bit for bit.
// out is (B, N/g) f32, the layout of subtile_max.cu.
//
// Replaces three TPU kernels of the JAX package:
//   rag_arc_tpu/ops/two_level.py::_subtile_max_kernel_i8_block (block mode)
//   rag_arc_tpu/ops/two_level_stream.py::_stream_kernel, int8 mode (the
//     raw maxima of the certified path; the masked block mode replaces it
//     and the certificate is gone)
//   rag_arc_tpu/ops/two_level.py::_subtile_max_kernel_i8 (row mode)
//
// What bounds it on an H100: 2*B*N*d int8 operations against N*d bytes
// of corpus, B operations per byte: the tensor cores, not HBM, are the
// limit from B of a few hundred (the card's dense int8 rate is twice its
// bf16 rate). This first version is the shape of subtile_max.cu's bf16
// kernel: WMMA m16n16k16 int8 fragments fed from shared memory by plain
// 16-byte loads, 128 corpus rows x 128 queries per block, queries the fast
// grid axis so blocks in flight share corpus rows. TMA, wgmma and a
// pipelined schedule are later work.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr float NEG = -3.0e38f;       // sentinel below any real score
constexpr int MASK_I32 = -(1 << 30);  // raw-dot sentinel of a dead row
constexpr int THREADS = 256;          // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int FRAG = 16;              // WMMA tile edge; one warp owns 16 rows
constexpr int ROWS = WARPS * FRAG;    // corpus rows per block
constexpr int QF = 8;                 // query fragments per warp
constexpr int QB = FRAG * QF;         // queries per block
constexpr int KC = 4;                 // 16-byte k chunks staged per step
constexpr int KT = KC * FRAG;         // d-slice per step (64 bytes)

// Copies 16 int8 values of row `src` from column k into dst, with zeros
// past d or for a row outside the matrix.
__device__ __forceinline__ void load16(signed char* dst, const signed char* src,
                                       int k, int d, bool row_ok, bool vec) {
  if (row_ok && vec && k + 16 <= d) {
    *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src + k);
    return;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    dst[i] = (row_ok && k + i < d) ? src[k + i] : static_cast<signed char>(0);
  }
}

// Stages a (rows x KT) slice of a row-major int8 matrix into shared memory
// as KC chunk-major tiles: chunk c holds rows x 16 bytes contiguously, so
// every 16 x 16 WMMA fragment is 256 contiguous, 32-byte-aligned bytes
// (ldm 16). Each group of 8 threads (one phase of a 16-byte store) takes 8
// different rows of one chunk, so its shared stores hit distinct banks,
// while a warp still reads 8 whole 64-byte row segments from global memory.
template <int R>
__device__ __forceinline__ void stage_slice(signed char (*dst)[R * FRAG],
                                            const signed char* src, long r0,
                                            long n_rows, int k0, int d,
                                            bool vec) {
  for (int c = threadIdx.x; c < R * KC; c += THREADS) {
    const int r = (c / 32) * 8 + (c % 8);
    const int kc = (c % 32) / 8;
    const long row = r0 + r;
    load16(&dst[kc][r * FRAG], src + row * d, k0 + kc * FRAG, d, row < n_rows,
           vec);
  }
}

template <bool BLOCK>
__global__ void __launch_bounds__(THREADS)
subtile_max_i8_kernel(const signed char* __restrict__ q,
                      const signed char* __restrict__ x,
                      const float* __restrict__ scale,
                      const uint8_t* __restrict__ valid,
                      float* __restrict__ out, int B, int N, int d, int g) {
  __shared__ __align__(32) signed char xs[KC][ROWS * FRAG];
  __shared__ __align__(32) signed char qs[KC][QB * FRAG];
  __shared__ __align__(32) int stage[WARPS][FRAG * FRAG];
  __shared__ int imax[BLOCK ? QB : 1][WARPS];    // block mode: raw maxima
  __shared__ float fmx[BLOCK ? 1 : QB][WARPS];   // row mode: scaled maxima

  const int n_qblk = (B + QB - 1) / QB;
  const int b0 = (blockIdx.x % n_qblk) * QB;
  const long r0 = (long)(blockIdx.x / n_qblk) * ROWS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // 16-byte loads need d % 16 == 0 and a 16-byte-aligned start: a view
  // with a storage offset takes the byte-wise loads
  const bool x_vec = d % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool q_vec = d % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;

  wmma::fragment<wmma::accumulator, FRAG, FRAG, FRAG, int> acc[QF];
#pragma unroll
  for (int j = 0; j < QF; ++j) wmma::fill_fragment(acc[j], 0);

  for (int k0 = 0; k0 < d; k0 += KT) {
    stage_slice<ROWS>(xs, x, r0, N, k0, d, x_vec);
    stage_slice<QB>(qs, q, b0, B, k0, d, q_vec);
    __syncthreads();
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      wmma::fragment<wmma::matrix_a, FRAG, FRAG, FRAG, signed char,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, &xs[kc][warp * FRAG * FRAG], FRAG);
#pragma unroll
      for (int j = 0; j < QF; ++j) {
        // q rows are the columns of B = qᵀ: column-major with stride 16
        wmma::fragment<wmma::matrix_b, FRAG, FRAG, FRAG, signed char,
                       wmma::col_major> bq;
        wmma::load_matrix_sync(bq, &qs[kc][j * FRAG * FRAG], FRAG);
        wmma::mma_sync(acc[j], a, bq, acc[j]);
      }
    }
    __syncthreads();
  }

  // epilogue: each warp reduces its 16 rows (dots[row][query]) to one
  // masked max per query, one fragment at a time through shared memory
  const long wrow = r0 + warp * FRAG;
  int* st = stage[warp];
#pragma unroll
  for (int j = 0; j < QF; ++j) {
    wmma::store_matrix_sync(st, acc[j], FRAG, wmma::mem_row_major);
    __syncwarp();
    if (lane < FRAG) {
      if constexpr (BLOCK) {
        int m = MASK_I32;
        for (int r = 0; r < FRAG; ++r) {
          const long row = wrow + r;
          if (row < N && valid[row]) m = max(m, st[r * FRAG + lane]);
        }
        imax[j * FRAG + lane][warp] = m;
      } else {
        float m = NEG;
        for (int r = 0; r < FRAG; ++r) {
          const long row = wrow + r;
          if (row < N && valid[row]) {
            m = fmaxf(m, static_cast<float>(st[r * FRAG + lane]) * scale[row]);
          }
        }
        fmx[j * FRAG + lane][warp] = m;
      }
    }
    __syncwarp();
  }
  __syncthreads();

  // g = 16*p rows per sub-tile: combine p neighbouring 16-row maxima;
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
    float res;
    if constexpr (BLOCK) {
      int m = MASK_I32;
      for (int p = 0; p < per; ++p) m = max(m, imax[bq][w * per + p]);
      res = m <= MASK_I32 / 2 ? NEG : static_cast<float>(m) * scale[t * g];
    } else {
      res = NEG;
      for (int p = 0; p < per; ++p) res = fmaxf(res, fmx[bq][w * per + p]);
    }
    out[(long)(b0 + bq) * n_sub + t] = res;
  }
}

}  // namespace

// C entry, bound with ctypes. block_scales: 1 = one scale per g-row
// sub-tile (scale[t*g] stands for it), 0 = per-row scales. The caller
// guarantees contiguous device buffers, N % g == 0, g in {16, 32, 64, 128}
// and d <= 1040. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success).
extern "C" int subtile_max_i8_launch(const void* q, const void* x,
                                     const void* scale, const void* valid,
                                     void* out, int B, int N, int d, int g,
                                     int block_scales, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long blocks = (((long)N + ROWS - 1) / ROWS) * ((B + QB - 1) / QB);
  const signed char* qc = static_cast<const signed char*>(q);
  const signed char* xc = static_cast<const signed char*>(x);
  const float* sc = static_cast<const float*>(scale);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(out);
  if (block_scales) {
    subtile_max_i8_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(
        qc, xc, sc, v, o, B, N, d, g);
  } else {
    subtile_max_i8_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(
        qc, xc, sc, v, o, B, N, d, g);
  }
  return (int)cudaGetLastError();
}
