// Int8 sub-tile max producer of the quantized two-level exact top-k, for
// Hopper (sm_90a).
//
// For int8 query codes q (B, d), int8 corpus codes x (N, d), f32 row
// scales scale (N,) and a row mask valid (N,) uint8, the dot q[b].x[r] is
// an int8 x int8 -> int32 product on the tensor cores, and
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
// limit from B of a few hundred (the card's dense int8 rate, 1,979 TOP/s,
// is twice its bf16 rate).
//
// The design is subtile_max.cu's bf16 kernel at s8 (csrc/hopper.cuh):
//
// - A tile is 128 corpus rows x a query block of QB = 128 or 256. A block
//   is a producer warpgroup (one thread issues the loads; setmaxnreg
//   hands its registers to the consumers: 168 a thread at launch, 40 and
//   232 after) and two consumer warpgroups; warpgroup w owns corpus rows
//   [64w, 64w + 64) of the tile x all QB queries as one m64nQBk32 s32
//   accumulator in registers (corpus = A, queries = B, both K-major: 8-bit
//   wgmma takes no transpose, and row-major codes are K-major).
// - Both operands arrive by TMA in 128-byte d slices (one 128B-swizzle
//   row: 128 int8, the geometry of the bf16 kernel's 64-wide slice, so a
//   k32 step advances the descriptor by 32 bytes) through a 4-stage ring
//   with a full/empty mbarrier pair per stage. TMA zero-fills rows past N
//   or B and columns past d; zero columns change no integer dot.
// - The grid is persistent (one block per SM); tiles are taken in order
//   with the query block the fast axis, so the blocks in flight share
//   corpus rows and the corpus streams from HBM about once. The ring runs
//   across tiles, so the next tile's first slices load under this one's
//   epilogue.
// - Epilogue in registers: each warp holds 16 consecutive corpus rows (one
//   g = 16 sub-tile) and each thread 2 of them for its columns. Block
//   mode takes the int32 max over the thread's 2 rows (MASK_I32 on dead
//   rows), row mode the f32 max of dot x scale[r] (NEG on dead rows); then
//   a reduce-scatter over lane bits 2-4 leaves each lane 2 columns' maxima
//   per 64 queries. valid and the scales are read before the mainloop, so
//   their latency hides under the wgmma: valid and (row mode) scale once
//   per row per tile, and (block mode) scale[t*g] of the one sub-tile t a
//   thread writes in the output loop. The maxima go through shared memory
//   only to be written as whole segments of each query's output row; for
//   g > 16 the neighbouring 16-row maxima are combined there, and block
//   mode applies scale[t*g] last.
//
// The operands must suit TMA: 16-byte-aligned bases and d % 16 == 0 (the
// wrapper copies an operand that is not into aligned, zero-padded
// storage).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG = -3.0e38f;       // sentinel below any real score
constexpr int MASK_I32 = -(1 << 30);  // raw-dot sentinel of a dead row
constexpr int ROWS = 128;             // corpus rows per tile: two warpgroups of 64
constexpr int KT = 128;               // d slice per stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;              // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;    // + a producer warpgroup (one thread loads)
constexpr int SUB = ROWS / 16;              // 16-row sub-tiles per tile (one per warp)

template <int QB>
struct Layout {
  static constexpr int X_BYTES = ROWS * KT;
  static constexpr int Q_BYTES = QB * KT;
  static constexpr int STAGE = X_BYTES + Q_BYTES;     // a multiple of 1024
  static constexpr int MAXES = QB * (SUB + 1) * 4;    // [query][sub-tile], padded
  static constexpr int BARS = 2 * STAGES * 8;
  static constexpr int SMEM = 1024 + STAGES * STAGE + MAXES + BARS;  // + alignment slack
};

template <int QB>
__device__ __forceinline__ void wgmma_tile(int (&acc)[QB / 2], uint64_t a, uint64_t b,
                                           int scale_d);

template <>
__device__ __forceinline__ void wgmma_tile<128>(int (&acc)[64], uint64_t a, uint64_t b,
                                                int scale_d) {
  hopper::wgmma_m64n128k32_s8_ss(acc, a, b, scale_d);
}

template <>
__device__ __forceinline__ void wgmma_tile<256>(int (&acc)[128], uint64_t a, uint64_t b,
                                                int scale_d) {
  hopper::wgmma_m64n256k32_s8_ss(acc, a, b, scale_d);
}

// The max of two epilogue values: raw int32 dots (block mode) or f32
// scores held as their bits (row mode).
template <bool BLOCK>
__device__ __forceinline__ int combine(int a, int b) {
  return BLOCK ? max(a, b) : __float_as_int(fmaxf(__int_as_float(a), __int_as_float(b)));
}

template <int QB, bool BLOCK>
__global__ void __launch_bounds__(THREADS, 1)
subtile_max_i8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                            const __grid_constant__ CUtensorMap qmap,
                            const float* __restrict__ scale, const uint8_t* __restrict__ valid,
                            float* __restrict__ out, int B, int N, int d, int g) {
  using Lay = Layout<QB>;
  static_assert(QB <= CONSUMERS, "one consumer thread per query column");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int* maxes = reinterpret_cast<int*>(smem + STAGES * Lay::STAGE);  // [QB][SUB + 1]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * Lay::STAGE + Lay::MAXES);
  uint64_t* empty = full + STAGES;

  const int n_qblk = (B + QB - 1) / QB;
  const long n_tiles = (long)((N + ROWS - 1) / ROWS) * n_qblk;
  const int n_k = (d + KT - 1) / KT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], CONSUMERS / 32);  // lane 0 of each consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup: it hands its registers to the consumers
    // (setmaxnreg works on whole warpgroups); one thread keeps the ring full
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      hopper::prefetch_map(&xmap);
      hopper::prefetch_map(&qmap);
      int stage = 0;
      uint32_t phase = 0;
      for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int r0 = (int)(tile / n_qblk) * ROWS;
        const int b0 = (int)(tile % n_qblk) * QB;
        for (int ks = 0; ks < n_k; ++ks) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * Lay::STAGE;
          hopper::mbar_arrive_expect_tx(&full[stage], Lay::STAGE);
          hopper::tma_load_2d(st, &xmap, &full[stage], ks * KT, r0);
          hopper::tma_load_2d(st + Lay::X_BYTES, &qmap, &full[stage], ks * KT, b0);
          if (++stage == STAGES) {
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
  const int n_out = ROWS / g;              // 8, 4, 2 or 1: g in {16, ..., 128}
  const int out_shift = __ffs(n_out) - 1;  // log2(n_out)
  const long n_sub = N / g;
  int acc[QB / 2];
#pragma unroll
  for (int i = 0; i < QB / 2; ++i) acc[i] = 0;
  int stage = 0;
  uint32_t phase = 0;

  for (long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int r0 = (int)(tile / n_qblk) * ROWS;
    const int b0 = (int)(tile % n_qblk) * QB;
    // what the epilogue reads of global memory, loaded before the mainloop
    // so that its latency hides under the wgmma: this thread's rows r_lo
    // and r_lo + 8 of its warp's sub-tile, and (row mode) their scales
    const int r_lo = r0 + warp * 16 + lane / 4;
    const int r_hi = r_lo + 8;
    const bool v_lo = r_lo < N && valid[r_lo];
    const bool v_hi = r_hi < N && valid[r_hi];
    float s_lo = 0.0f, s_hi = 0.0f;
    if (!BLOCK) {
      s_lo = r_lo < N ? scale[r_lo] : 0.0f;
      s_hi = r_hi < N ? scale[r_hi] : 0.0f;
    } else {
      // the output loop below gives this thread the one sub-tile
      // t0 + (threadIdx.x & (n_out - 1)) of every query it writes
      const long t = r0 / g + (threadIdx.x & (n_out - 1));
      s_lo = t < n_sub ? scale[t * g] : 0.0f;
    }
    for (int ks = 0; ks < n_k; ++ks) {
      hopper::mbar_wait(&full[stage], phase);
      const uint32_t xa = hopper::smem_u32(smem + stage * Lay::STAGE) + wg * 64 * KT;
      const uint32_t qa = hopper::smem_u32(smem + stage * Lay::STAGE + Lay::X_BYTES);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KT / 32; ++kk) {
        wgmma_tile<QB>(acc, hopper::desc_sw128(xa + kk * 32, 16, 1024),
                       hopper::desc_sw128(qa + kk * 32, 16, 1024), (ks | kk) != 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue, in registers. First the masked max over this thread's two
    // rows, kept in acc[4j + e] (column 8j + 2 (lane % 4) + e): raw int32
    // in block mode, f32 bits of dot x scale in row mode
#pragma unroll
    for (int j = 0; j < QB / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int lo = acc[4 * j + e], hi = acc[4 * j + 2 + e];
        if (BLOCK) {
          acc[4 * j + e] = max(v_lo ? lo : MASK_I32, v_hi ? hi : MASK_I32);
        } else {
          acc[4 * j + e] = __float_as_int(fmaxf(v_lo ? (float)lo * s_lo : NEG,
                                                v_hi ? (float)hi * s_hi : NEG));
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
          const int lo = acc[4 * j + e];
          const int hi = acc[4 * (j + (1 << s)) + e];
          const int theirs = __shfl_xor_sync(0xffffffffu, up ? lo : hi, 4 << s);
          acc[4 * j + e] = combine<BLOCK>(up ? hi : lo, theirs);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < QB / 64; ++m) {
#pragma unroll
      for (int e = 0; e < 2; ++e) maxes[(64 * m + 2 * lane + e) * (SUB + 1) + warp] = acc[32 * m + e];
    }
    hopper::named_barrier_sync(1, CONSUMERS);

    // g = 16 * per rows a sub-tile: combine per neighbouring 16-row
    // maxima; consecutive threads write consecutive sub-tiles of a query
    const long t0 = r0 / g;
    for (int i = threadIdx.x; i < QB * n_out; i += CONSUMERS) {
      const int bq = i >> out_shift;
      const int w = i & (n_out - 1);
      const long t = t0 + w;
      if (b0 + bq >= B || t >= n_sub) continue;
      int m = maxes[bq * (SUB + 1) + w * per];
      for (int p = 1; p < per; ++p) m = combine<BLOCK>(m, maxes[bq * (SUB + 1) + w * per + p]);
      float res;
      if (BLOCK) {
        res = m <= MASK_I32 / 2 ? NEG : static_cast<float>(m) * s_lo;  // scale[t * g]
      } else {
        res = __int_as_float(m);
      }
      out[(long)(b0 + bq) * n_sub + t] = res;
    }
    hopper::named_barrier_sync(1, CONSUMERS);  // maxes is free for the next tile
  }
}

template <int QB, bool BLOCK>
int launch(const void* q, const void* x, const float* scale, const uint8_t* v, float* o, int B,
           int N, int d, int g, cudaStream_t s) {
  // TMA: 16-byte-aligned bases, row strides a multiple of 16 bytes
  if (d % 16 != 0 || (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(x)) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, qmap;
  const uint64_t xdims[2] = {(uint64_t)d, (uint64_t)N}, qdims[2] = {(uint64_t)d, (uint64_t)B};
  const uint64_t stride[1] = {(uint64_t)d};
  const uint32_t xbox[2] = {KT, ROWS}, qbox[2] = {KT, QB};
  // int8 codes are copied as bytes: a 128-element box is one swizzle row
  if (!hopper::make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, x, 2, xdims, stride, xbox) ||
      !hopper::make_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, 2, qdims, stride, qbox))
    return (int)cudaErrorInvalidValue;
  auto kernel = subtile_max_i8_wgmma_kernel<QB, BLOCK>;
  const int smem = Layout<QB>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long tiles = (long)((N + ROWS - 1) / ROWS) * ((B + QB - 1) / QB);
  const int grid = (int)(tiles < hopper::sm_count() ? tiles : hopper::sm_count());
  kernel<<<grid, THREADS, smem, s>>>(xmap, qmap, scale, v, o, B, N, d, g);
  return (int)cudaGetLastError();
}

template <bool BLOCK>
int launch_mode(const void* q, const void* x, const float* scale, const uint8_t* v, float* o,
                int B, int N, int d, int g, cudaStream_t s) {
  // a 128-query block while it covers B, else 256
  if (B <= 128) return launch<128, BLOCK>(q, x, scale, v, o, B, N, d, g, s);
  return launch<256, BLOCK>(q, x, scale, v, o, B, N, d, g, s);
}

}  // namespace

// C entry, bound with ctypes. block_scales: 1 = one scale per g-row
// sub-tile (scale[t*g] stands for it), 0 = per-row scales. The caller
// guarantees contiguous device buffers, N % g == 0, g in {16, 32, 64, 128},
// d <= 1040, 16-byte-aligned q and x and d % 16 == 0 (else
// cudaErrorInvalidValue). Launches on `stream`, does not synchronise, and
// returns the CUDA error of the launch (0 on success).
extern "C" int subtile_max_i8_launch(const void* q, const void* x, const void* scale,
                                     const void* valid, void* out, int B, int N, int d, int g,
                                     int block_scales, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  float* o = static_cast<float*>(out);
  if (block_scales) return launch_mode<true>(q, x, sc, v, o, B, N, d, g, s);
  return launch_mode<false>(q, x, sc, v, o, B, N, d, g, s);
}
