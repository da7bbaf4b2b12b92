// Pipelined sub-tile max producer of the two-level exact top-k, for Hopper
// (sm_90a).
//
// The same function as subtile_max.cu (bf16/f32) and as the block mode of
// subtile_max_i8.cu (int8), for queries q (B, d), corpus x (N, d) and a row
// mask valid (N,) uint8:
//
//   bf16/f32: out[b, t] = max over live r in sub-tile t of q[b].x[r]
//             (f32 accumulation), NEG when no row is live;
//   int8:     out[b, t] = scale[t*g] * (max over live r of the raw int32
//             dot), NEG when no row is live (one scale per g-row sub-tile).
//
// out is (B, N/g) f32, g in {16, 32, 64} (a 64-row tile holds whole
// sub-tiles; the wrapper serves g = 128 and 256 from g = 64 maxima).
//
// Replaces rag_arc_tpu/ops/two_level_stream.py:53 _stream_kernel_piped (the
// TPU kernel's pipelined producer, subtile_max_stream(pipelined=True)). On
// the TPU one core runs the grid in order; that kernel issues tile i's
// matmul on the MXU before it reduces tile i-1's score slab on the VPU, so
// the two units overlap. Here the same overlap is a warpgroup ping-pong
// (bf16 and int8):
//
// - A block is a producer warpgroup (one thread issues TMA loads;
//   setmaxnreg leaves it 40 registers and the consumers 232) and two
//   consumer warpgroups. A tile is 64 corpus rows x a query block of
//   QB = 128 or 256, one m64nQB wgmma accumulator in registers (corpus =
//   A, queries = B; bf16 k16 or s8 k32 steps, csrc/hopper.cuh).
// - The consumer warpgroups take alternate tiles of the block, each a
//   whole tile. Ordered named barriers (TURN) let only one of them issue
//   its mainloop at a time, in tile order, so warpgroup A issues tile i's
//   wgmma while warpgroup B runs tile i-1's masked sub-tile-max epilogue
//   and writes it out: the tensor cores never wait for an epilogue.
//   Inside a mainloop one wgmma group stays in flight (wait<1>), because
//   no second warpgroup fills the gaps between k-steps.
// - Both operands arrive by TMA in 128-byte d slices (64 bf16 or 128
//   int8, 128-byte swizzle) through a 4-stage ring with a full/empty
//   mbarrier pair per stage, consumed in tile order; a stage is released
//   by the one warpgroup that read it. TMA zero-fills rows past N or B and
//   columns past d.
// - The grid is persistent (one block per SM); tiles go in order with the
//   query block the fast axis, so blocks in flight share corpus rows and
//   the corpus streams from HBM about once.
// - The epilogue is subtile_max.cu's register reduce-scatter over lane
//   bits 2-4 (and, for int8, subtile_max_i8.cu's: raw int32 maxima with
//   MASK_I32 on dead rows, scale[t*g] loaded before the mainloop); valid is
//   read before the mainloop, so its latency hides under the wgmma.
//
// What bounds it on an H100 is what bounds subtile_max.cu: 2*B*N*d
// tensor-core operations against N*d*elem bytes, compute-bound at B = 512.
// The operands must suit TMA: 16-byte-aligned bases and rows of a multiple
// of 16 bytes (the wrapper copies an operand that is not).
//
// f32 stays on CUDA cores (no TF32, which would change rankings against
// the f32 reference): a 64-row x 64-query block of FMAs, subtile_max.cu's
// f32 kernel at the piped tile height.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG = -3.0e38f;       // sentinel below any real score
constexpr int MASK_I32 = -(1 << 30);  // raw-dot sentinel of a dead row (int8)

enum Mode { F32 = 0, BF16 = 1, I8 = 2 };

// ------------------------------------------------------ bf16 and int8 --

constexpr int ROWS = 64;        // corpus rows per tile: one warpgroup's m64
constexpr int SLICE = 128;      // bytes of a row per stage: one swizzle row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 256;  // two consumer warpgroups
constexpr int THREADS = CONSUMERS + 128;  // + a producer warpgroup
constexpr int SUB = ROWS / 16;  // 16-row sub-tiles per tile (one per warp)

// named barriers (0 is __syncthreads, used once before the roles split)
constexpr int BAR_TURN = 1;  // + wg: warpgroup wg may issue its mainloop
constexpr int BAR_WG = 3;    // + wg: the warpgroup's own epilogue

template <int QB>
struct Layout {
  static constexpr int X_BYTES = ROWS * SLICE;
  static constexpr int STAGE = X_BYTES + QB * SLICE;  // a multiple of 1024
  static constexpr int MAXES = 2 * QB * (SUB + 1) * 4;  // per warpgroup [query][sub-tile]
  static constexpr int BARS = 2 * STAGES * 8;
  static constexpr int SMEM = 1024 + STAGES * STAGE + MAXES + BARS;  // + alignment slack
};

// One k-step of the tile on the tensor cores: bf16 k16 (f32 accumulate)
// or s8 k32 (s32 accumulate), both 32 bytes along d.
template <int QB>
__device__ __forceinline__ void mma(float (&acc)[QB / 2], uint64_t a, uint64_t b, int sd) {
  if constexpr (QB == 128) hopper::wgmma_m64n128k16_ss(acc, a, b, sd);
  else hopper::wgmma_m64n256k16_ss(acc, a, b, sd);
}

template <int QB>
__device__ __forceinline__ void mma(int (&acc)[QB / 2], uint64_t a, uint64_t b, int sd) {
  if constexpr (QB == 128) hopper::wgmma_m64n128k32_s8_ss(acc, a, b, sd);
  else hopper::wgmma_m64n256k32_s8_ss(acc, a, b, sd);
}

// The accumulator's type and a dead row's value: f32 scores (bf16) or raw
// int32 dots (int8).
template <int MODE>
struct Acc {
  using T = float;
  static constexpr float DEAD = NEG;
};
template <>
struct Acc<I8> {
  using T = int;
  static constexpr int DEAD = MASK_I32;
};

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }

template <int QB, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
piped_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap qmap,
                   const uint8_t* __restrict__ valid, const float* __restrict__ scale,
                   float* __restrict__ out, int B, int N, int d, int g) {
  using Lay = Layout<QB>;
  using T = typename Acc<MODE>::T;
  constexpr T DEAD = Acc<MODE>::DEAD;
  constexpr int KT = MODE == I8 ? SLICE : SLICE / 2;  // elements per slice
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * Lay::STAGE + Lay::MAXES);
  uint64_t* empty = full + STAGES;

  const int n_qblk = (B + QB - 1) / QB;
  const long n_tiles = (long)((N + ROWS - 1) / ROWS) * n_qblk;
  const int n_k = (d + KT - 1) / KT;
  // the launch gives every block at least one tile
  const long n_local = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);  // lane 0 of each warp of the one reader
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup: one thread keeps the ring full, in tile order
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      hopper::prefetch_map(&xmap);
      hopper::prefetch_map(&qmap);
      long slice = 0;
      for (long i = 0; i < n_local; ++i) {
        const long tile = blockIdx.x + i * gridDim.x;
        const int r0 = (int)(tile / n_qblk) * ROWS;
        const int b0 = (int)(tile % n_qblk) * QB;
        for (int ks = 0; ks < n_k; ++ks, ++slice) {
          const int stage = (int)(slice % STAGES);
          hopper::mbar_wait(&empty[stage], (uint32_t)((slice / STAGES) & 1) ^ 1);
          unsigned char* st = smem + stage * Lay::STAGE;
          hopper::mbar_arrive_expect_tx(&full[stage], Lay::STAGE);
          hopper::tma_load_2d(st, &xmap, &full[stage], ks * KT, r0);
          hopper::tma_load_2d(st + Lay::X_BYTES, &qmap, &full[stage], ks * KT, b0);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes the block's tiles wg, wg + 2, ...
  hopper::setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;  // owns the tile's 16-row sub-tile `warp`
  const int lane = tid % 32;
  const int per = g / 16;
  const int n_out = ROWS / g;              // 4, 2 or 1: g in {16, 32, 64}
  const int out_shift = __ffs(n_out) - 1;  // log2(n_out)
  const long n_sub = N / g;
  T* maxes = reinterpret_cast<T*>(smem + STAGES * Lay::STAGE) + wg * QB * (SUB + 1);
  T acc[QB / 2];

  for (long i = wg; i < n_local; i += 2) {
    const long tile = blockIdx.x + i * gridDim.x;
    const int r0 = (int)(tile / n_qblk) * ROWS;
    const int b0 = (int)(tile % n_qblk) * QB;
    // what the epilogue reads of global memory, loaded before the mainloop:
    // this thread's rows r_lo and r_lo + 8 and (int8) the scale of the one
    // sub-tile t0 + (tid & (n_out - 1)) the output loop gives it
    const int r_lo = r0 + warp * 16 + lane / 4;
    const int r_hi = r_lo + 8;
    const bool v_lo = r_lo < N && valid[r_lo];
    const bool v_hi = r_hi < N && valid[r_hi];
    float s_t = 0.0f;
    if constexpr (MODE == I8) {
      const long t = r0 / g + (tid & (n_out - 1));
      s_t = t < n_sub ? scale[t * g] : 0.0f;
    }

    // mainloop, in turn with the other warpgroup
    if (i >= 1) hopper::named_barrier_sync(BAR_TURN + wg, CONSUMERS);
    long slice = i * n_k;
    int prev = 0;
    for (int ks = 0; ks < n_k; ++ks, ++slice) {
      const int stage = (int)(slice % STAGES);
      hopper::mbar_wait(&full[stage], (uint32_t)((slice / STAGES) & 1));
      const uint32_t xa = hopper::smem_u32(smem + stage * Lay::STAGE);
      const uint32_t qa = xa + Lay::X_BYTES;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SLICE / 32; ++kk) {
        mma<QB>(acc, hopper::desc_sw128(xa + kk * 32, 16, 1024),
                hopper::desc_sw128(qa + kk * 32, 16, 1024), (ks | kk) != 0);
      }
      hopper::wgmma_commit();
      if (ks > 0) {  // the previous k-step is done: its stage is free
        hopper::wgmma_wait<1>();
        if (lane == 0) hopper::mbar_arrive(&empty[prev]);
      }
      prev = stage;
    }
    if (i + 1 < n_local) hopper::named_barrier_arrive(BAR_TURN + (wg ^ 1), CONSUMERS);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[prev]);

    // epilogue, in registers: the masked max over this thread's two rows,
    // kept in acc[4j + e] (column 8j + 2 (lane % 4) + e)
#pragma unroll
    for (int j = 0; j < QB / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e)
        acc[4 * j + e] = vmax(v_lo ? acc[4 * j + e] : DEAD, v_hi ? acc[4 * j + 2 + e] : DEAD);
    }
    // then over the 8 lanes that share those columns (lane bits 2-4), as a
    // reduce-scatter: at step s a lane keeps half its column groups j and
    // takes its partner's values for them, ending with columns
    // 64m + 2 lane + e
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const bool up = (lane >> (2 + s)) & 1;
#pragma unroll
      for (int j = 0; j < QB / 8; j += 2 << s) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const T lo = acc[4 * j + e];
          const T hi = acc[4 * (j + (1 << s)) + e];
          const T theirs = __shfl_xor_sync(0xffffffffu, up ? lo : hi, 4 << s);
          acc[4 * j + e] = vmax(up ? hi : lo, theirs);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < QB / 64; ++m) {
#pragma unroll
      for (int e = 0; e < 2; ++e) maxes[(64 * m + 2 * lane + e) * (SUB + 1) + warp] = acc[32 * m + e];
    }
    hopper::named_barrier_sync(BAR_WG + wg, 128);

    // g = 16 * per rows a sub-tile: combine per neighbouring 16-row
    // maxima; consecutive threads write consecutive sub-tiles of a query
    const long t0 = r0 / g;
    for (int c = tid; c < QB * n_out; c += 128) {
      const int bq = c >> out_shift;
      const int w = c & (n_out - 1);
      const long t = t0 + w;
      if (b0 + bq >= B || t >= n_sub) continue;
      T m = maxes[bq * (SUB + 1) + w * per];
      for (int p = 1; p < per; ++p) m = vmax(m, maxes[bq * (SUB + 1) + w * per + p]);
      float res;
      if constexpr (MODE == I8) {
        res = m <= MASK_I32 / 2 ? NEG : static_cast<float>(m) * s_t;  // scale[t * g]
      } else {
        res = static_cast<float>(m);
      }
      out[(long)(b0 + bq) * n_sub + t] = res;
    }
    hopper::named_barrier_sync(BAR_WG + wg, 128);  // maxes is free for the next tile
  }
}

// ----------------------------------------------------------------- f32 --

constexpr int F_THREADS = 256;  // 8 warps
constexpr int F_ROWS = 64;      // corpus rows per block
constexpr int FQB = 64;         // queries per block
constexpr int FKT = 32;         // d-slice per step

// 256 threads, each owning 4 rows x 4 queries of the 64 x 64 block.
__global__ void __launch_bounds__(F_THREADS)
piped_f32_kernel(const float* __restrict__ q, const float* __restrict__ x,
                 const uint8_t* __restrict__ valid, float* __restrict__ out, int B, int N,
                 int d, int g) {
  __shared__ float xs[FKT][F_ROWS + 4];  // k-major: rows contiguous
  __shared__ float qs[FKT][FQB + 4];
  __shared__ float ss[F_ROWS][FQB + 1];

  const int n_qblk = (B + FQB - 1) / FQB;
  const int b0 = (blockIdx.x % n_qblk) * FQB;
  const long r0 = (long)(blockIdx.x / n_qblk) * F_ROWS;
  const int tq = threadIdx.x % 16;  // queries tq*4 .. tq*4+3
  const int tr = threadIdx.x / 16;  // rows tr*4 .. tr*4+3

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += FKT) {
    for (int c = threadIdx.x; c < F_ROWS * FKT; c += F_THREADS) {
      const int r = c / FKT, kk = c % FKT;
      const long row = r0 + r;
      xs[kk][r] = (row < N && k0 + kk < d) ? x[row * d + k0 + kk] : 0.0f;
    }
    for (int c = threadIdx.x; c < FQB * FKT; c += F_THREADS) {
      const int r = c / FKT, kk = c % FKT;
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

  const int n_out = F_ROWS / g;
  const long n_sub = N / g;
  const long t0 = r0 / g;
  for (int i = threadIdx.x; i < FQB * n_out; i += F_THREADS) {
    const int bq = i / n_out, w = i % n_out;
    const long t = t0 + w;
    if (b0 + bq >= B || t >= n_sub) continue;
    float m = NEG;
    for (int r = 0; r < g; ++r)
      if (valid[r0 + (long)w * g + r]) m = fmaxf(m, ss[w * g + r][bq]);
    out[(long)(b0 + bq) * n_sub + t] = m;
  }
}

template <int QB, int MODE>
int launch_wgmma(const void* q, const void* x, const uint8_t* v, const float* sc, float* o,
                 int B, int N, int d, int g, cudaStream_t s) {
  // TMA: 16-byte-aligned bases, rows a multiple of 16 bytes
  const int elem = MODE == I8 ? 1 : 2;
  if ((d * elem) % 16 != 0 || (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(x)) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, qmap;
  const uint64_t xdims[2] = {(uint64_t)d, (uint64_t)N}, qdims[2] = {(uint64_t)d, (uint64_t)B};
  const uint64_t stride[1] = {(uint64_t)d * elem};
  const uint32_t kt = SLICE / elem;
  const uint32_t xbox[2] = {kt, ROWS}, qbox[2] = {kt, QB};
  // int8 codes are copied as bytes: a 128-element box is one swizzle row
  const CUtensorMapDataType dt =
      MODE == I8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!hopper::make_map(&xmap, dt, x, 2, xdims, stride, xbox) ||
      !hopper::make_map(&qmap, dt, q, 2, qdims, stride, qbox))
    return (int)cudaErrorInvalidValue;
  auto kernel = piped_wgmma_kernel<QB, MODE>;
  const int smem = Layout<QB>::SMEM;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long tiles = (long)((N + ROWS - 1) / ROWS) * ((B + QB - 1) / QB);
  const int grid = (int)(tiles < hopper::sm_count() ? tiles : hopper::sm_count());
  kernel<<<grid, THREADS, smem, s>>>(xmap, qmap, v, sc, o, B, N, d, g);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_mode(const void* q, const void* x, const uint8_t* v, const float* sc, float* o,
                int B, int N, int d, int g, cudaStream_t s) {
  // a 128-query block while it covers B, else 256
  if (B <= 128) return launch_wgmma<128, MODE>(q, x, v, sc, o, B, N, d, g, s);
  return launch_wgmma<256, MODE>(q, x, v, sc, o, B, N, d, g, s);
}

}  // namespace

// C entry, bound with ctypes. mode: 0 = float32, 1 = bfloat16, 2 = int8
// (block scales; `scale` (N,) f32, scale[t*g] stands for sub-tile t). The
// caller guarantees contiguous device buffers, N % g == 0 and g in
// {16, 32, 64}; for bf16 and int8 also 16-byte-aligned q and x and rows of
// a multiple of 16 bytes (else cudaErrorInvalidValue). Launches on
// `stream`, does not synchronise, and returns the CUDA error of the launch
// (0 on success).
extern "C" int subtile_max_piped_launch(const void* q, const void* x, const void* valid,
                                        const void* scale, void* out, int B, int N, int d,
                                        int g, int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  if (N <= 0 || B <= 0) return 0;
  if (g != 16 && g != 32 && g != 64) return (int)cudaErrorInvalidValue;
  switch (mode) {
    case F32: {
      const long blocks = (((long)N + F_ROWS - 1) / F_ROWS) * ((B + FQB - 1) / FQB);
      piped_f32_kernel<<<(unsigned)blocks, F_THREADS, 0, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(x), v, o, B, N, d, g);
      return (int)cudaGetLastError();
    }
    case BF16: return launch_mode<BF16>(q, x, v, sc, o, B, N, d, g, s);
    case I8:
      if (sc == nullptr) return (int)cudaErrorInvalidValue;
      return launch_mode<I8>(q, x, v, sc, o, B, N, d, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
