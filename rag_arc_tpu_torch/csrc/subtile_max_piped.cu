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
// out is (B, N/g) f32.
//
// Replaces rag_arc_tpu/ops/two_level_stream.py:53 _stream_kernel_piped (the
// TPU kernel's pipelined producer, subtile_max_stream(pipelined=True)). On
// the TPU one core runs the grid in order; that kernel issues tile i's
// matmul on the MXU before it reduces tile i-1's score slab on the VPU, two
// slabs, so the two units overlap. This kernel overlaps the same two things
// on an SM, and the load of the next tile besides:
//
//   - warp specialisation: 8 MMA warps compute a 128-row x 64-query score
//     tile on the tensor cores (WMMA; SIMT FMAs for f32, no TF32), 4 reduce
//     warps take the masked sub-tile maxima of a finished tile and write
//     them out;
//   - two score slabs in shared memory: while the reduce warps read slab
//     (i-1) % 2, the MMA warps compute tile i into registers and store it
//     to slab i % 2. Named barriers hand a slab over (FULL: MMA -> reduce)
//     and back (FREE: reduce -> MMA); the MMA warps wait for a slab only
//     from the third tile on;
//   - a 3-stage cp.async ring of 64-byte k-slices of corpus and query rows:
//     the loads of k-step s+2 are in flight while the tensor cores run
//     k-step s, and the ring runs on across tile boundaries, so the first
//     slices of tile i+1 arrive while tile i finishes.
//
// Each block is persistent over its query block: it walks the corpus tiles
// p, p+P, p+2P, ... with the query block as the fast grid axis, so the
// blocks in flight share corpus tiles and the corpus is read from HBM about
// once. What bounds it on an H100 is what bounds subtile_max.cu: 2*B*N*d
// tensor-core operations against N*d*elem bytes, compute-bound at B = 512.
// The wrapper (ops/subtile_max_piped.py) requires rows of a multiple of 16
// bytes starting on 16-byte boundaries (every cp.async moves 16 bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr float NEG = -3.0e38f;       // sentinel below any real score
constexpr int MASK_I32 = -(1 << 30);  // raw-dot sentinel of a dead row (int8)
constexpr int MMA_WARPS = 8;
constexpr int RED_WARPS = 4;
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int RED_THREADS = RED_WARPS * 32;
constexpr int THREADS = MMA_THREADS + RED_THREADS;
constexpr int FRAG = 16;                 // WMMA tile edge
constexpr int ROWS = MMA_WARPS * FRAG;   // corpus rows per tile: 128
constexpr int QB = 64;                   // queries per block
constexpr int QF = QB / FRAG;            // query fragments per MMA warp
constexpr int KB = 64;                   // bytes of a row per k-step
constexpr int PITCH = KB + 16;           // staged row pitch in bytes (bf16, f32)
constexpr int STAGES = 3;
constexpr int X_BYTES = ROWS * PITCH;    // 10240; int8 uses 4 x 128 x 16 = 8192
constexpr int STAGE_BYTES = X_BYTES + QB * PITCH;
constexpr int LDR = ROWS + 4;            // slab pitch: slab[query][row]
constexpr int SLAB_WORDS = QB * LDR;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * SLAB_WORDS * 4;

// named barriers (0 is __syncthreads, unused once the roles split)
constexpr int BAR_MMA = 1;   // the MMA warps among themselves
constexpr int BAR_FULL = 2;  // + slab: the slab holds a finished tile
constexpr int BAR_FREE = 4;  // + slab: the reduce warps are done with it

enum Mode { F32 = 0, BF16 = 1, I8 = 2 };

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// 16-byte async copy global -> shared; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Issues the copies of one k-step (64 bytes of each of the tile's 128 corpus
// rows and of the block's 64 query rows) into ring stage `st`. int8 stages
// are chunk-major (chunk c holds rows x 16 bytes) so that every WMMA
// fragment starts on a 32-byte boundary; bf16/f32 stages are row-major with
// an 80-byte pitch.
template <int MODE>
__device__ __forceinline__ void issue_kstep(unsigned char* st,
                                            const unsigned char* x,
                                            const unsigned char* q, long r0,
                                            int b0, int N, int B,
                                            long row_bytes, int ks, int tid) {
  const long kbyte = (long)ks * KB;
  // corpus: 128 rows x 4 chunks, two per thread
#pragma unroll
  for (int i = 0; i < (ROWS * 4) / MMA_THREADS; ++i) {
    const int c = tid + i * MMA_THREADS;
    const int r = c >> 2, ch = c & 3;
    const long row = r0 + r;
    const long off = kbyte + ch * 16;
    const bool ok = row < N && off < row_bytes;
    unsigned char* dst = MODE == I8 ? st + ch * (ROWS * 16) + r * 16
                                    : st + r * PITCH + ch * 16;
    cp_async16(dst, ok ? x + row * row_bytes + off : x, ok ? 16 : 0);
  }
  // queries: 64 rows x 4 chunks, one per thread
  {
    const int r = tid >> 2, ch = tid & 3;
    const long qrow = b0 + r;
    const long off = kbyte + ch * 16;
    const bool ok = qrow < B && off < row_bytes;
    unsigned char* qs = st + X_BYTES;
    unsigned char* dst = MODE == I8 ? qs + ch * (QB * 16) + r * 16
                                    : qs + r * PITCH + ch * 16;
    cp_async16(dst, ok ? q + qrow * row_bytes + off : q, ok ? 16 : 0);
  }
}

// The MMA warps' accumulators for one 128 x 64 tile, per mode.
template <int MODE>
struct Acc;

template <>
struct Acc<BF16> {
  wmma::fragment<wmma::accumulator, FRAG, FRAG, FRAG, float> f[QF];
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < QF; ++j) wmma::fill_fragment(f[j], 0.0f);
  }
  __device__ void step(const unsigned char* st, int warp, int) {
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* qs = reinterpret_cast<const __nv_bfloat16*>(st + X_BYTES);
    constexpr int LD = PITCH / 2;  // 40 elements
#pragma unroll
    for (int kk = 0; kk < KB / 2; kk += FRAG) {
      wmma::fragment<wmma::matrix_a, FRAG, FRAG, FRAG, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, xs + warp * FRAG * LD + kk, LD);
#pragma unroll
      for (int j = 0; j < QF; ++j) {
        // q rows are the columns of B = q^T: column-major with stride LD
        wmma::fragment<wmma::matrix_b, FRAG, FRAG, FRAG, __nv_bfloat16,
                       wmma::col_major> bq;
        wmma::load_matrix_sync(bq, qs + j * FRAG * LD + kk, LD);
        wmma::mma_sync(f[j], a, bq, f[j]);
      }
    }
  }
  __device__ void store(float* slab, int warp, int) {
    // column-major store: element (row m, query n) lands at slab[n][m]
#pragma unroll
    for (int j = 0; j < QF; ++j) {
      wmma::store_matrix_sync(slab + j * FRAG * LDR + warp * FRAG, f[j], LDR,
                              wmma::mem_col_major);
    }
  }
};

template <>
struct Acc<I8> {
  wmma::fragment<wmma::accumulator, FRAG, FRAG, FRAG, int> f[QF];
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < QF; ++j) wmma::fill_fragment(f[j], 0);
  }
  __device__ void step(const unsigned char* st, int warp, int) {
    const signed char* xs = reinterpret_cast<const signed char*>(st);
    const signed char* qs = reinterpret_cast<const signed char*>(st + X_BYTES);
#pragma unroll
    for (int ch = 0; ch < KB / 16; ++ch) {
      wmma::fragment<wmma::matrix_a, FRAG, FRAG, FRAG, signed char,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, xs + ch * (ROWS * 16) + warp * FRAG * 16, 16);
#pragma unroll
      for (int j = 0; j < QF; ++j) {
        wmma::fragment<wmma::matrix_b, FRAG, FRAG, FRAG, signed char,
                       wmma::col_major> bq;
        wmma::load_matrix_sync(bq, qs + ch * (QB * 16) + j * FRAG * 16, 16);
        wmma::mma_sync(f[j], a, bq, f[j]);
      }
    }
  }
  __device__ void store(float* slab, int warp, int) {
    int* s = reinterpret_cast<int*>(slab);
#pragma unroll
    for (int j = 0; j < QF; ++j) {
      wmma::store_matrix_sync(s + j * FRAG * LDR + warp * FRAG, f[j], LDR,
                              wmma::mem_col_major);
    }
  }
};

// f32: CUDA-core FMAs. MMA thread t owns rows (t % 32) + 32 i, i < 4, and
// queries (t / 32) * 8 + j, j < 8; a row's 16-byte reads by 8 neighbouring
// threads fall in distinct bank groups (80-byte pitch), a query's are a
// broadcast.
template <>
struct Acc<F32> {
  float a[4][8];
  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) a[i][j] = 0.0f;
  }
  __device__ void step(const unsigned char* st, int, int tid) {
    const int tr = tid & 31, tq = tid >> 5;
    const unsigned char* qs = st + X_BYTES;
#pragma unroll
    for (int kk = 0; kk < KB; kk += 16) {
      float4 xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xv[i] = *reinterpret_cast<const float4*>(st + (tr + 32 * i) * PITCH + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 qv =
            *reinterpret_cast<const float4*>(qs + (tq * 8 + j) * PITCH + kk);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float s = a[i][j];
          s = fmaf(xv[i].x, qv.x, s);
          s = fmaf(xv[i].y, qv.y, s);
          s = fmaf(xv[i].z, qv.z, s);
          s = fmaf(xv[i].w, qv.w, s);
          a[i][j] = s;
        }
      }
    }
  }
  __device__ void store(float* slab, int, int tid) {
    const int tr = tid & 31, tq = tid >> 5;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) slab[(tq * 8 + j) * LDR + tr + 32 * i] = a[i][j];
  }
};

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
subtile_max_piped_kernel(const void* __restrict__ qv, const void* __restrict__ xv,
                         const uint8_t* __restrict__ valid,
                         const float* __restrict__ scale,
                         float* __restrict__ out, int B, int N, int d, int g,
                         int parts) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  float* slabs = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);

  const int n_qblk = (B + QB - 1) / QB;
  const int b0 = (blockIdx.x % n_qblk) * QB;
  const int part = blockIdx.x / n_qblk;
  const int n_tiles = (N + ROWS - 1) / ROWS;
  const int my_tiles = part < n_tiles ? (n_tiles - 1 - part) / parts + 1 : 0;
  constexpr int ELEM = MODE == F32 ? 4 : (MODE == BF16 ? 2 : 1);
  const long row_bytes = (long)d * ELEM;
  const int ksteps = (int)((row_bytes + KB - 1) / KB);
  const int warp = threadIdx.x / 32;

  if (warp < MMA_WARPS) {
    // ------------------------------------------------------ MMA warps --
    const int tid = threadIdx.x;
    const unsigned char* x = static_cast<const unsigned char*>(xv);
    const unsigned char* q = static_cast<const unsigned char*>(qv);
    const long total = (long)my_tiles * ksteps;
    // prologue: the first STAGES-1 k-steps in flight
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < total) {
        const long r0 = (long)(part + (s / ksteps) * parts) * ROWS;
        issue_kstep<MODE>(ring + s * STAGE_BYTES, x, q, r0, b0, N, B,
                          row_bytes, s % ksteps, tid);
      }
      cp_commit();
    }
    Acc<MODE> acc;
    acc.zero();
    for (long s = 0; s < total; ++s) {
      cp_wait<STAGES - 2>();   // this thread's copies of k-step s landed
      bar_sync(BAR_MMA, MMA_THREADS);  // everyone's did; stage s-1 is free
      const long nxt = s + STAGES - 1;
      if (nxt < total) {
        const long r0 = (long)(part + (nxt / ksteps) * parts) * ROWS;
        issue_kstep<MODE>(ring + (nxt % STAGES) * STAGE_BYTES, x, q, r0, b0,
                          N, B, row_bytes, (int)(nxt % ksteps), tid);
      }
      cp_commit();
      acc.step(ring + (s % STAGES) * STAGE_BYTES, warp, tid);
      if ((s + 1) % ksteps == 0) {  // the tile is done: hand it to a slab
        const long it = s / ksteps;
        const int slab = (int)(it & 1);
        if (it >= 2) bar_sync(BAR_FREE + slab, THREADS);
        acc.store(slabs + slab * SLAB_WORDS, warp, tid);
        __threadfence_block();
        bar_arrive(BAR_FULL + slab, THREADS);
        acc.zero();
      }
    }
    cp_wait<0>();
  } else {
    // --------------------------------------------------- reduce warps --
    const int rt = threadIdx.x - MMA_THREADS;
    const int n_out = ROWS / g;  // sub-tiles per tile
    const long n_sub = N / g;
    for (int it = 0; it < my_tiles; ++it) {
      const int slab = it & 1;
      bar_sync(BAR_FULL + slab, THREADS);
      const float* sl = slabs + slab * SLAB_WORDS;
      const long r0 = (long)(part + (long)it * parts) * ROWS;
      const long t0 = r0 / g;
      // consecutive threads take consecutive sub-tiles of one query, so a
      // warp's stores cover whole 32-byte segments of an output row
      for (int i = rt; i < QB * n_out; i += RED_THREADS) {
        const int bq = i / n_out;
        const int w = i % n_out;
        const long t = t0 + w;
        if (b0 + bq >= B || t >= n_sub) continue;
        const long row0 = t * g;
        float res;
        if constexpr (MODE == I8) {
          const int* src = reinterpret_cast<const int*>(sl) + bq * LDR + w * g;
          int m = MASK_I32;
          for (int r = 0; r < g; ++r)
            if (valid[row0 + r]) m = max(m, src[r]);
          res = m <= MASK_I32 / 2 ? NEG : static_cast<float>(m) * scale[row0];
        } else {
          const float* src = sl + bq * LDR + w * g;
          res = NEG;
          for (int r = 0; r < g; ++r)
            if (valid[row0 + r]) res = fmaxf(res, src[r]);
        }
        out[(long)(b0 + bq) * n_sub + t] = res;
      }
      // the MMA warps wait for a slab from their third tile on: the last
      // two tiles' slabs are never waited for, so no arrival is left open
      if (it + 2 < my_tiles) {
        __threadfence_block();
        bar_arrive(BAR_FREE + slab, THREADS);
      }
    }
  }
}

template <int MODE>
int launch(const void* q, const void* x, const uint8_t* v, const float* sc,
           float* o, int B, int N, int d, int g, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      subtile_max_piped_kernel<MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_qblk = (B + QB - 1) / QB;
  const int n_tiles = (N + ROWS - 1) / ROWS;
  // two resident blocks per SM, the corpus split into `parts` strided
  // streams of tiles per query block
  int parts = (2 * sms + n_qblk - 1) / n_qblk;
  if (parts > n_tiles) parts = n_tiles;
  if (parts < 1) parts = 1;
  const long blocks = (long)parts * n_qblk;
  subtile_max_piped_kernel<MODE><<<(unsigned)blocks, THREADS, SMEM_BYTES, s>>>(
      q, x, v, sc, o, B, N, d, g, parts);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. mode: 0 = float32, 1 = bfloat16, 2 = int8
// (block scales; `scale` (N,) f32, scale[t*g] stands for sub-tile t). The
// caller guarantees contiguous device buffers whose rows are a multiple of
// 16 bytes and start 16-byte aligned, N % g == 0 and g in {16, 32, 64, 128}.
// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// (0 on success).
extern "C" int subtile_max_piped_launch(const void* q, const void* x,
                                        const void* valid, const void* scale,
                                        void* out, int B, int N, int d, int g,
                                        int mode, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const float* sc = static_cast<const float*>(scale);
  float* o = static_cast<float*>(out);
  if (N <= 0 || B <= 0) return 0;
  switch (mode) {
    case F32: return launch<F32>(q, x, v, sc, o, B, N, d, g, s);
    case BF16: return launch<BF16>(q, x, v, sc, o, B, N, d, g, s);
    case I8:
      if (sc == nullptr) return (int)cudaErrorInvalidValue;
      return launch<I8>(q, x, v, sc, o, B, N, d, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
