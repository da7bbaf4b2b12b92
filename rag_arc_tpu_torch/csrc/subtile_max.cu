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
// compute-bound at B = 512 and byte-bound at small B.
//
// The bf16 design (wgmma fed by TMA):
//
// - A tile is 128 corpus rows x a query block of QB = 128 or 256. A block
//   is a producer warpgroup (one thread issues the loads; setmaxnreg
//   hands its registers to the consumers: 168 a thread at launch, 40 and
//   232 after) and two consumer warpgroups; warpgroup w owns corpus rows
//   [64w, 64w + 64) of the tile x all QB queries as one m64nQBk16 f32
//   accumulator in registers (corpus = A, queries = B).
// - Both operands arrive by TMA in 64-wide d slices (128-byte swizzle)
//   through a 4-stage ring with a full/empty mbarrier pair per stage: the
//   producer keeps the ring full, so the load of slice s+3 overlaps the
//   wgmma on slice s. TMA zero-fills rows past N or B and columns past d.
// - The grid is persistent (one block per SM); tiles are taken in order
//   with the query block the fast axis, so the blocks in flight share
//   corpus rows and the corpus streams from HBM about once. The ring runs
//   across tiles, so the next tile's first slices load under this one's
//   epilogue.
// - Epilogue in registers: in the accumulator layout each warp holds 16
//   consecutive corpus rows (one g = 16 sub-tile) and each thread 2 of
//   them for its columns. The masked max of a sub-tile is a max over the
//   thread's 2 rows, then over lane bits 2, 3 and 4 as a reduce-scatter
//   (56 shuffles a thread at QB = 256, not 192: each step halves the
//   columns a lane carries). valid and sqnorm are read once per row per
//   tile, qsq once per column per tile (staged in shared memory), all
//   loaded before the mainloop so their latency hides under the wgmma;
//   the l2 mode takes the min of (qsq - 2 dot) + sqnorm and negates it
//   once, bit for bit the max of the score. The (query, sub-tile) maxima
//   go through shared memory only to be written as whole 32-byte segments
//   of each query's output row; for g > 16 the neighbouring 16-row maxima
//   are combined there.
//
// The operands must suit TMA: 16-byte-aligned bases and d % 8 == 0 (the
// wrapper copies an operand that is not into aligned, zero-padded
// storage).
//
// The f32 path uses CUDA-core FMAs in a 128 x 32 block tiling; TF32 would
// change rankings against the f32 reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG = -3.0e38f;  // sentinel below any real score

// ---------------------------------------------------------------- bf16 --

constexpr int W_ROWS = 128;          // corpus rows per tile: two warpgroups of 64
constexpr int W_KT = 64;             // d slice per stage: one 128-byte swizzle row
constexpr int W_STAGES = 4;
constexpr int W_CONSUMERS = 256;     // two consumer warpgroups
constexpr int W_THREADS = W_CONSUMERS + 128;  // + a producer warpgroup (one thread loads)
constexpr int W_SUB = W_ROWS / 16;   // 16-row sub-tiles per tile (one per warp)

template <int QB>
struct WLayout {
  static constexpr int X_BYTES = W_ROWS * W_KT * 2;
  static constexpr int Q_BYTES = QB * W_KT * 2;
  static constexpr int STAGE = X_BYTES + Q_BYTES;  // a multiple of 1024
  static constexpr int MAXES = QB * (W_SUB + 1) * 4;  // [query][sub-tile], padded
  static constexpr int QSQ = QB * 4;
  static constexpr int BARS = 2 * W_STAGES * 8;
  static constexpr int SMEM = 1024 + W_STAGES * STAGE + MAXES + QSQ + BARS;  // + alignment slack
};

// The l2 score of a row from its dot product (L2) or the dot itself.
template <bool L2>
__device__ __forceinline__ float row_score(float dot, float qsq, float sqn) {
  return L2 ? -((qsq - 2.0f * dot) + sqn) : dot;
}

template <int QB>
__device__ __forceinline__ void wgmma_tile(float (&acc)[QB / 2], uint64_t a, uint64_t b,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_tile<128>(float (&acc)[64], uint64_t a, uint64_t b,
                                                int scale_d) {
  hopper::wgmma_m64n128k16_ss(acc, a, b, scale_d);
}

template <>
__device__ __forceinline__ void wgmma_tile<256>(float (&acc)[128], uint64_t a, uint64_t b,
                                                int scale_d) {
  hopper::wgmma_m64n256k16_ss(acc, a, b, scale_d);
}

template <int QB, bool L2>
__global__ void __launch_bounds__(W_THREADS, 1)
subtile_max_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap qmap,
                         const uint8_t* __restrict__ valid, const float* __restrict__ qsq,
                         const float* __restrict__ sqnorm, float* __restrict__ out, int B,
                         int N, int d, int g) {
  using Lay = WLayout<QB>;
  static_assert(QB <= W_CONSUMERS, "one consumer thread per query column");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* maxes = reinterpret_cast<float*>(smem + W_STAGES * Lay::STAGE);  // [QB][W_SUB + 1]
  float* qsq_s = maxes + QB * (W_SUB + 1);  // the tile's query norms (l2)
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + W_STAGES * Lay::STAGE + Lay::MAXES + Lay::QSQ);
  uint64_t* empty = full + W_STAGES;

  const int n_qblk = (B + QB - 1) / QB;
  const long n_tiles = (long)((N + W_ROWS - 1) / W_ROWS) * n_qblk;
  const int n_k = (d + W_KT - 1) / W_KT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], W_CONSUMERS / 32);  // lane 0 of each consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= W_CONSUMERS) {
    // ---- producer warpgroup: it hands its registers to the consumers
    // (setmaxnreg works on whole warpgroups); one thread keeps the ring full
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == W_CONSUMERS) {
      hopper::prefetch_map(&xmap);
      hopper::prefetch_map(&qmap);
      int stage = 0;
      uint32_t phase = 0;
      for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int r0 = (int)(tile / n_qblk) * W_ROWS;
        const int b0 = (int)(tile % n_qblk) * QB;
        for (int ks = 0; ks < n_k; ++ks) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * Lay::STAGE;
          hopper::mbar_arrive_expect_tx(&full[stage], Lay::STAGE);
          hopper::tma_load_2d(st, &xmap, &full[stage], ks * W_KT, r0);
          hopper::tma_load_2d(st + Lay::X_BYTES, &qmap, &full[stage], ks * W_KT, b0);
          if (++stage == W_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of a tile;
  // 384 x 168 registers at launch, the producer's share moved here
  hopper::setmaxnreg_inc<232>();
  // warp `warp` (0..7) owns the 16-row sub-tile `warp`
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int per = g / 16;
  const int n_out = W_ROWS / g;            // 8, 4, 2 or 1: g in {16, ..., 128}
  const int out_shift = __ffs(n_out) - 1;  // log2(n_out)
  const long n_sub = N / g;
  float acc[QB / 2];
#pragma unroll
  for (int i = 0; i < QB / 2; ++i) acc[i] = 0.0f;
  int stage = 0;
  uint32_t phase = 0;

  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = (int)(tile / n_qblk) * W_ROWS;
    const int b0 = (int)(tile % n_qblk) * QB;
    // what the epilogue reads of global memory, loaded before the mainloop
    // so that its latency hides under the wgmma: this thread's rows r_lo
    // and r_lo + 8 of its warp's sub-tile, and (l2) one column's qsq
    const int r_lo = r0 + warp * 16 + lane / 4;
    const int r_hi = r_lo + 8;
    const bool v_lo = r_lo < N && valid[r_lo];
    const bool v_hi = r_hi < N && valid[r_hi];
    float sq_lo = 0.0f, sq_hi = 0.0f, q_col = 0.0f;
    if (L2) {
      sq_lo = r_lo < N ? sqnorm[r_lo] : 0.0f;
      sq_hi = r_hi < N ? sqnorm[r_hi] : 0.0f;
      q_col = threadIdx.x < QB && b0 + (int)threadIdx.x < B ? qsq[b0 + threadIdx.x] : 0.0f;
    }
    for (int ks = 0; ks < n_k; ++ks) {
      hopper::mbar_wait(&full[stage], phase);
      const uint32_t xa = hopper::smem_u32(smem + stage * Lay::STAGE) + wg * 64 * 128;
      const uint32_t qa = hopper::smem_u32(smem + stage * Lay::STAGE + Lay::X_BYTES);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W_KT / 16; ++kk) {
        wgmma_tile<QB>(acc, hopper::desc_sw128(xa + kk * 32, 16, 1024),
                       hopper::desc_sw128(qa + kk * 32, 16, 1024), (ks | kk) != 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
      if (++stage == W_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue, in registers. First the masked max over this thread's two
    // rows, kept in acc[4j + e] (column 8j + 2 (lane % 4) + e). l2 scores
    // are -((qsq - 2 dot) + sqnorm): their max is minus the min of
    // (qsq - 2 dot) + sqnorm, a dead row counting as -NEG.
    if (L2) {  // qsq_s is free: the last tile's readers are past its final barrier
      if (threadIdx.x < QB) qsq_s[threadIdx.x] = q_col;
      hopper::named_barrier_sync(1, W_CONSUMERS);
    }
#pragma unroll
    for (int j = 0; j < QB / 8; ++j) {
      float2 q2 = make_float2(0.0f, 0.0f);
      if (L2) q2 = *reinterpret_cast<const float2*>(qsq_s + 8 * j + 2 * (lane % 4));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (L2) {
          const float qe = e ? q2.y : q2.x;
          const float s_lo = v_lo ? (qe - 2.0f * acc[4 * j + e]) + sq_lo : -NEG;
          const float s_hi = v_hi ? (qe - 2.0f * acc[4 * j + 2 + e]) + sq_hi : -NEG;
          acc[4 * j + e] = fminf(s_lo, s_hi);
        } else {
          acc[4 * j + e] = fmaxf(v_lo ? acc[4 * j + e] : NEG, v_hi ? acc[4 * j + 2 + e] : NEG);
        }
      }
    }
    // Then over the 8 lanes that share those columns (lane bits 2-4), as a
    // reduce-scatter: at step s a lane keeps half its column groups j (by
    // bit s of j, its lane bit 2 + s choosing which half) and takes its
    // partner's values for them. It ends with j = 8m + lane / 4, that is
    // columns 64m + 2 lane + e, every lane busy.
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const bool up = (lane >> (2 + s)) & 1;
#pragma unroll
      for (int j = 0; j < QB / 8; j += 2 << s) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lo = acc[4 * j + e];
          const float hi = acc[4 * (j + (1 << s)) + e];
          const float theirs = __shfl_xor_sync(0xffffffffu, up ? lo : hi, 4 << s);
          const float mine = up ? hi : lo;
          acc[4 * j + e] = L2 ? fminf(mine, theirs) : fmaxf(mine, theirs);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < QB / 64; ++m) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float x = acc[32 * m + e];
        maxes[(64 * m + 2 * lane + e) * (W_SUB + 1) + warp] = L2 ? -x : x;
      }
    }
    hopper::named_barrier_sync(1, W_CONSUMERS);

    // g = 16 * per rows a sub-tile: combine per neighbouring 16-row
    // maxima; consecutive threads write consecutive sub-tiles of a query
    const long t0 = r0 / g;
    for (int i = threadIdx.x; i < QB * n_out; i += W_CONSUMERS) {
      const int bq = i >> out_shift;
      const int w = i & (n_out - 1);
      const long t = t0 + w;
      if (b0 + bq >= B || t >= n_sub) continue;
      float m = NEG;
      for (int p = 0; p < per; ++p) m = fmaxf(m, maxes[bq * (W_SUB + 1) + w * per + p]);
      out[(long)(b0 + bq) * n_sub + t] = m;
    }
    hopper::named_barrier_sync(1, W_CONSUMERS);  // maxes is free for the next tile
  }
}

// ----------------------------------------------------------------- f32 --

constexpr int THREADS = 256;  // 8 warps
constexpr int ROWS = 128;     // corpus rows per block
constexpr int FQB = 32;       // queries per block
constexpr int FKT = 32;       // d-slice per step

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

template <int QB, bool L2>
int launch_bf16(const void* q, const void* x, const uint8_t* v, const float* qsq,
                const float* sqn, float* o, int B, int N, int d, int g, cudaStream_t s) {
  // TMA: 16-byte-aligned bases, row strides a multiple of 16 bytes
  if (d % 8 != 0 || (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(x)) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, qmap;
  const uint64_t xdims[2] = {(uint64_t)d, (uint64_t)N}, qdims[2] = {(uint64_t)d, (uint64_t)B};
  const uint64_t stride[1] = {(uint64_t)d * 2};
  const uint32_t xbox[2] = {W_KT, W_ROWS}, qbox[2] = {W_KT, QB};
  if (!hopper::make_map_bf16(&xmap, x, 2, xdims, stride, xbox) ||
      !hopper::make_map_bf16(&qmap, q, 2, qdims, stride, qbox))
    return (int)cudaErrorInvalidValue;
  auto kernel = subtile_max_wgmma_kernel<QB, L2>;
  const int smem = WLayout<QB>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long tiles = (long)((N + W_ROWS - 1) / W_ROWS) * ((B + QB - 1) / QB);
  const int grid = (int)(tiles < hopper::sm_count() ? tiles : hopper::sm_count());
  kernel<<<grid, W_THREADS, smem, s>>>(xmap, qmap, v, qsq, sqn, o, B, N, d, g);
  return (int)cudaGetLastError();
}

template <bool L2>
int launch(const void* q, const void* x, const uint8_t* v, const float* qsq,
           const float* sqn, float* o, int B, int N, int d, int g, int dtype,
           cudaStream_t s) {
  if (dtype == 1) {
    // a 128-query block while it covers B, else 256
    if (B <= 128) return launch_bf16<128, L2>(q, x, v, qsq, sqn, o, B, N, d, g, s);
    return launch_bf16<256, L2>(q, x, v, qsq, sqn, o, B, N, d, g, s);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const long blocks = (((long)N + ROWS - 1) / ROWS) * ((B + FQB - 1) / FQB);
  subtile_max_f32_kernel<L2><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(x), v, qsq, sqn, o, B, N, d, g);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16. qsq (B,)
// and sqnorm (N,) f32 select the l2 mode; both null for cosine/ip. The
// caller guarantees contiguous device buffers, N % g == 0 and g in
// {16, 32, 64, 128}; for bf16 also 16-byte-aligned q and x and d % 8 == 0
// (else cudaErrorInvalidValue). Launches on `stream`, does not
// synchronise, and returns the CUDA error of the launch (0 on success).
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
