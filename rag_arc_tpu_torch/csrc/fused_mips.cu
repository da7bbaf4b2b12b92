// Fused MIPS + top-k for Hopper (sm_90a): (B, k) scores and positions with
// no (B, N) score matrix in device memory.
//
// Replaces rag_arc_tpu/ops/fused_mips.py:50 _fused_kernel (fused_mips_topk).
// The TPU kernel walks the corpus tiles in order on one core and folds each
// tile's scores into a running (B, k) list in VMEM. Blocks on a GPU run in
// no order, so here:
//
//   fused_mips_kernel: a grid of (query block x corpus split). A block holds
//     64 queries' running top-k lists in shared memory and walks its split
//     in 128-row chunks: the chunk's 128 x 64 scores are computed on the
//     tensor cores (WMMA bf16; SIMT FMAs for f32, no TF32) into a shared
//     slab, then each warp folds 8 queries' candidates into their lists. A
//     3-stage cp.async ring of 64-byte k-slices runs on across chunks, so
//     the next chunk's first slices load while the warps fold.
//   merge_kernel: one warp per query merges the splits' lists.
//
// The order is total, so the split-and-merge result equals the TPU's
// sequential one:
//   not packed: score desc, then position asc;
//   packed:     the score quantized by the order-preserving key transform
//               with the low idx_bits of the key cleared (what the TPU's
//               packed extraction returns), then tile asc (tile = position
//               / tile_n), then in-tile column desc.
// Dead rows never enter; slots beyond the live count are (NEG, -1).
//
// Folding a candidate: it enters only if it ranks above the list's k-th
// entry; its slot is the count of entries that rank above it (a ballot
// over the sorted list), and the tail shifts down one. skip_tiles = 1 folds
// only the candidates above the k-th (the TPU's threshold early exit: the
// same result, since a candidate at or below the k-th cannot enter); 0
// extracts the chunk's top k per query in k rounds of warp argmax first, as
// the TPU kernel does, and folds those.
//
// What bounds it on an H100: the 2*B*N*d operations of the scores (the
// corpus is read once, B*N scores never leave the SM), compute-bound at
// B = 512; the fold adds CUDA-core work per chunk that shrinks as the lists'
// thresholds rise. The wrapper (ops/fused_mips.py) requires rows of a
// multiple of 16 bytes starting 16-byte aligned, and k <= 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr float NEG = -3.0e38f;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int FRAG = 16;
constexpr int ROWS = WARPS * FRAG;    // 128 rows per chunk
constexpr int QB = 64;                // queries per block
constexpr int QF = QB / FRAG;
constexpr int QPW = QB / WARPS;       // queries folded per warp
constexpr int KB = 64;                // bytes of a row per k-step
constexpr int PITCH = KB + 16;        // staged row pitch in bytes
constexpr int STAGES = 3;
constexpr int X_BYTES = ROWS * PITCH;
constexpr int STAGE_BYTES = X_BYTES + QB * PITCH;
constexpr int LDR = ROWS + 4;         // slab[query][row]
constexpr int SLAB_BYTES = QB * LDR * 4;
constexpr int KMAX = 128;
constexpr int KPL = KMAX / 32;        // list entries per lane

struct Ctx {
  int k;
  int tile_n;
  int packed;    // 1: the packed order and quantized scores
  int low_mask;  // (1 << idx_bits) - 1
};

// a ranks strictly above b; an empty slot (position < 0) ranks below all
__device__ __forceinline__ bool beats(float as, int ap, float bs, int bp,
                                      const Ctx& c) {
  if (bp < 0) return ap >= 0;
  if (ap < 0) return false;
  if (as != bs) return as > bs;
  if (!c.packed) return ap < bp;
  const int ta = ap / c.tile_n, tb = bp / c.tile_n;
  if (ta != tb) return ta < tb;
  return ap > bp;
}

// the packed extraction's score: the order-preserving key with its low
// idx_bits cleared, mapped back to a float
__device__ __forceinline__ float quantize(float s, int low_mask) {
  const int bits = __float_as_int(s);
  const int keyed = bits >= 0 ? bits : bits ^ 0x7FFFFFFF;
  const int kq = keyed & ~low_mask;
  return __int_as_float(kq >= 0 ? kq : kq ^ 0x7FFFFFFF);
}

// Puts (s, p), which ranks above the list's k-th entry, into the sorted
// list of one query. All 32 lanes of the warp call it with the same (s, p).
__device__ __forceinline__ void insert(float* ls, int* lp, float s, int p,
                                       const Ctx& c, int lane) {
  int above = 0;
#pragma unroll
  for (int t = 0; t < KPL; ++t) {
    const int j = lane + 32 * t;
    if (j < c.k && beats(ls[j], lp[j], s, p, c)) ++above;
  }
  const int pos = __reduce_add_sync(0xffffffffu, above);
  float vs[KPL];
  int vp[KPL];
#pragma unroll
  for (int t = 0; t < KPL; ++t) {
    const int j = pos + lane + 32 * t;
    if (j < c.k - 1) {
      vs[t] = ls[j];
      vp[t] = lp[j];
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < KPL; ++t) {
    const int j = pos + lane + 32 * t;
    if (j < c.k - 1) {
      ls[j + 1] = vs[t];
      lp[j + 1] = vp[t];
    }
  }
  if (lane == 0) {
    ls[pos] = s;
    lp[pos] = p;
  }
  __syncwarp();
}

// Folds each lane's candidates (cs[i], cp[i]; cp < 0 = none) into the list:
// every candidate above the k-th entry enters.
template <int NC>
__device__ __forceinline__ void fold_above(float* ls, int* lp, float (&cs)[NC],
                                           int (&cp)[NC], const Ctx& c,
                                           int lane) {
  float ts = ls[c.k - 1];
  int tp = lp[c.k - 1];
  bool want[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) want[i] = cp[i] >= 0 && beats(cs[i], cp[i], ts, tp, c);
  while (true) {
    int src = -1, slot = 0;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const unsigned m = __ballot_sync(0xffffffffu, want[i]);
      if (src < 0 && m) {
        src = __ffs(m) - 1;
        slot = i;
      }
    }
    if (src < 0) break;
    float s = 0.0f;
    int p = -1;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const float si = __shfl_sync(0xffffffffu, cs[i], src);
      const int pi = __shfl_sync(0xffffffffu, cp[i], src);
      if (i == slot) {
        s = si;
        p = pi;
      }
    }
    insert(ls, lp, s, p, c, lane);
    if (lane == src) {
#pragma unroll
      for (int i = 0; i < NC; ++i)
        if (i == slot) want[i] = false;
    }
    ts = ls[c.k - 1];
    tp = lp[c.k - 1];
#pragma unroll
    for (int i = 0; i < NC; ++i) want[i] = want[i] && beats(cs[i], cp[i], ts, tp, c);
  }
}

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
__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One k-step of copies (64 bytes of each of the chunk's 128 corpus rows and
// the block's 64 query rows), row-major at an 80-byte pitch.
__device__ __forceinline__ void issue_kstep(unsigned char* st,
                                            const unsigned char* x,
                                            const unsigned char* q, long r0,
                                            int b0, int N, int B,
                                            long row_bytes, int ks, int tid) {
  const long kbyte = (long)ks * KB;
#pragma unroll
  for (int i = 0; i < (ROWS * 4) / THREADS; ++i) {
    const int c = tid + i * THREADS;
    const int r = c >> 2, ch = c & 3;
    const long row = r0 + r;
    const long off = kbyte + ch * 16;
    const bool ok = row < N && off < row_bytes;
    cp_async16(st + r * PITCH + ch * 16, ok ? x + row * row_bytes + off : x,
               ok ? 16 : 0);
  }
  const int r = tid >> 2, ch = tid & 3;
  const long qrow = b0 + r;
  const long off = kbyte + ch * 16;
  const bool ok = qrow < B && off < row_bytes;
  cp_async16(st + X_BYTES + r * PITCH + ch * 16,
             ok ? q + qrow * row_bytes + off : q, ok ? 16 : 0);
}

template <bool BF16>
struct Acc;

template <>
struct Acc<true> {
  wmma::fragment<wmma::accumulator, FRAG, FRAG, FRAG, float> f[QF];
  __device__ void zero() {
#pragma unroll
    for (int j = 0; j < QF; ++j) wmma::fill_fragment(f[j], 0.0f);
  }
  __device__ void step(const unsigned char* st, int warp, int) {
    const __nv_bfloat16* xs = reinterpret_cast<const __nv_bfloat16*>(st);
    const __nv_bfloat16* qs = reinterpret_cast<const __nv_bfloat16*>(st + X_BYTES);
    constexpr int LD = PITCH / 2;
#pragma unroll
    for (int kk = 0; kk < KB / 2; kk += FRAG) {
      wmma::fragment<wmma::matrix_a, FRAG, FRAG, FRAG, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, xs + warp * FRAG * LD + kk, LD);
#pragma unroll
      for (int j = 0; j < QF; ++j) {
        wmma::fragment<wmma::matrix_b, FRAG, FRAG, FRAG, __nv_bfloat16,
                       wmma::col_major> bq;
        wmma::load_matrix_sync(bq, qs + j * FRAG * LD + kk, LD);
        wmma::mma_sync(f[j], a, bq, f[j]);
      }
    }
  }
  __device__ void store(float* slab, int warp, int) {
#pragma unroll
    for (int j = 0; j < QF; ++j)
      wmma::store_matrix_sync(slab + j * FRAG * LDR + warp * FRAG, f[j], LDR,
                              wmma::mem_col_major);
  }
};

// f32: thread t owns rows (t % 32) + 32 i and queries (t / 32) * 8 + j
template <>
struct Acc<false> {
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

template <bool BF16>
__global__ void __launch_bounds__(THREADS, 2)
fused_mips_kernel(const void* __restrict__ qv, const void* __restrict__ xv,
                  const uint8_t* __restrict__ valid,
                  const float* __restrict__ qsq,
                  const float* __restrict__ sqnorm,
                  float* __restrict__ part_s, int* __restrict__ part_p, int B,
                  int N, int d, int chunks_per_split, int skip, Ctx c) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  float* slab = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES);
  float* lists_s = reinterpret_cast<float*>(smem + STAGES * STAGE_BYTES + SLAB_BYTES);
  int* lists_p = reinterpret_cast<int*>(lists_s + QB * c.k);

  const int n_qblk = (B + QB - 1) / QB;
  const int b0 = (blockIdx.x % n_qblk) * QB;
  const int split = blockIdx.x / n_qblk;
  const int n_chunks = (N + ROWS - 1) / ROWS;
  const int c0 = split * chunks_per_split;
  const int c1 = min(n_chunks, c0 + chunks_per_split);
  const int my_chunks = max(0, c1 - c0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  constexpr int ELEM = BF16 ? 2 : 4;
  const long row_bytes = (long)d * ELEM;
  const int ksteps = (int)((row_bytes + KB - 1) / KB);
  const unsigned char* x = static_cast<const unsigned char*>(xv);
  const unsigned char* q = static_cast<const unsigned char*>(qv);

  for (int i = tid; i < QB * c.k; i += THREADS) {
    lists_s[i] = NEG;
    lists_p[i] = -1;
  }

  const long total = (long)my_chunks * ksteps;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total)
      issue_kstep(ring + s * STAGE_BYTES, x, q, (long)(c0 + s / ksteps) * ROWS,
                  b0, N, B, row_bytes, s % ksteps, tid);
    cp_commit();
  }
  Acc<BF16> acc;
  acc.zero();
  for (long s = 0; s < total; ++s) {
    cp_wait1();
    __syncthreads();  // k-step s has landed for all; stage s-1 is free
    const long nxt = s + STAGES - 1;
    if (nxt < total)
      issue_kstep(ring + (nxt % STAGES) * STAGE_BYTES, x, q,
                  (long)(c0 + nxt / ksteps) * ROWS, b0, N, B, row_bytes,
                  (int)(nxt % ksteps), tid);
    cp_commit();
    acc.step(ring + (s % STAGES) * STAGE_BYTES, warp, tid);
    if ((s + 1) % ksteps) continue;

    // the chunk's scores are complete: through the slab into the lists
    acc.store(slab, warp, tid);
    acc.zero();
    __syncthreads();
    const long r0 = (long)(c0 + s / ksteps) * ROWS;
    for (int qq = 0; qq < QPW; ++qq) {
      const int qi = warp * QPW + qq;
      const int b = b0 + qi;
      if (b >= B) break;
      float* ls = lists_s + qi * c.k;
      int* lp = lists_p + qi * c.k;
      const float q2 = sqnorm != nullptr ? qsq[b] : 0.0f;
      float cs[4];
      int cpos[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = lane + 32 * i;
        const long row = r0 + r;
        cpos[i] = -1;
        cs[i] = NEG;
        if (row < N && valid[row]) {
          float v = slab[qi * LDR + r];
          if (sqnorm != nullptr) v = -((q2 - 2.0f * v) + sqnorm[row]);
          cs[i] = c.packed ? quantize(v, c.low_mask) : v;
          cpos[i] = (int)row;
        }
      }
      if (skip) {
        fold_above<4>(ls, lp, cs, cpos, c, lane);
      } else {
        // the TPU's k extraction rounds: the chunk's best remaining
        // candidate each round, folded if it ranks above the k-th
        for (int round = 0; round < c.k; ++round) {
          float bs = NEG;
          int bp = -1;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (beats(cs[i], cpos[i], bs, bp, c)) {
              bs = cs[i];
              bp = cpos[i];
            }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
            const float os = __shfl_xor_sync(0xffffffffu, bs, o);
            const int op = __shfl_xor_sync(0xffffffffu, bp, o);
            if (beats(os, op, bs, bp, c)) {
              bs = os;
              bp = op;
            }
          }
          if (bp < 0) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (cpos[i] == bp) cpos[i] = -1;
          float one_s[1] = {bs};
          int one_p[1] = {lane == 0 ? bp : -1};
          fold_above<1>(ls, lp, one_s, one_p, c, lane);
        }
      }
    }
    // the slab is written again only after the next chunk's k-steps, each
    // of which starts with __syncthreads
  }
  cp_wait0();
  __syncthreads();
  for (int i = tid; i < QB * c.k; i += THREADS) {
    const int b = b0 + i / c.k;
    if (b >= B) continue;
    const long o = ((long)split * B + b) * c.k + i % c.k;
    part_s[o] = lists_s[i];
    part_p[o] = lists_p[i];
  }
}

// one warp per query: the top k of the union of the splits' lists
__global__ void __launch_bounds__(THREADS)
merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_p,
             float* __restrict__ out_s, int* __restrict__ out_p, int B,
             int splits, Ctx c) {
  __shared__ float ls_all[WARPS][KMAX];
  __shared__ int lp_all[WARPS][KMAX];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * WARPS + warp;
  if (b >= B) return;
  float* ls = ls_all[warp];
  int* lp = lp_all[warp];
  for (int j = lane; j < c.k; j += 32) {
    ls[j] = NEG;
    lp[j] = -1;
  }
  __syncwarp();
  for (int sp = 0; sp < splits; ++sp) {
    const long base = ((long)sp * B + b) * c.k;
    for (int j0 = 0; j0 < c.k; j0 += 32) {
      float cs[1] = {NEG};
      int cp[1] = {-1};
      if (j0 + lane < c.k) {
        cs[0] = part_s[base + j0 + lane];
        cp[0] = part_p[base + j0 + lane];
      }
      fold_above<1>(ls, lp, cs, cp, c, lane);
    }
  }
  for (int j = lane; j < c.k; j += 32) {
    out_s[(long)b * c.k + j] = ls[j];
    out_p[(long)b * c.k + j] = lp[j];
  }
}

// Shared memory one block of the fused kernel takes for lists of k.
int smem_bytes(int k) { return STAGES * STAGE_BYTES + SLAB_BYTES + QB * k * 8; }

}  // namespace

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16. qsq (B,)
// and sqnorm (N,) f32 select the l2 score -((qsq - 2 q.x) + sqnorm); both
// null otherwise. part_s/part_p are (splits, B, k) scratch, out_s/out_p the
// (B, k) result. The caller guarantees contiguous device buffers with rows
// of a multiple of 16 bytes starting 16-byte aligned, 1 <= k <= 128 and
// splits * chunks_per_split * 128 >= N. Launches both kernels on `stream`,
// does not synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int fused_mips_launch(const void* q, const void* x, const void* valid,
                                 const void* qsq, const void* sqnorm,
                                 void* part_s, void* part_p, void* out_s,
                                 void* out_p, int B, int N, int d, int k,
                                 int tile_n, int packed, int idx_bits, int skip,
                                 int splits, int chunks_per_split, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > KMAX || B <= 0) return (int)cudaErrorInvalidValue;
  if ((qsq == nullptr) != (sqnorm == nullptr)) return (int)cudaErrorInvalidValue;
  Ctx c{k, tile_n, packed, packed ? (int)((1u << idx_bits) - 1u) : 0};
  const int smem = smem_bytes(k);
  const int n_qblk = (B + QB - 1) / QB;
  const dim3 grid((unsigned)(n_qblk * splits));
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const float* qs = static_cast<const float*>(qsq);
  const float* sq = static_cast<const float*>(sqnorm);
  float* ps = static_cast<float*>(part_s);
  int* pp = static_cast<int*>(part_p);
  cudaError_t err;
  if (dtype == 1) {
    err = cudaFuncSetAttribute(fused_mips_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    fused_mips_kernel<true><<<grid, THREADS, smem, s>>>(
        q, x, v, qs, sq, ps, pp, B, N, d, chunks_per_split, skip, c);
  } else if (dtype == 0) {
    err = cudaFuncSetAttribute(fused_mips_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    fused_mips_kernel<false><<<grid, THREADS, smem, s>>>(
        q, x, v, qs, sq, ps, pp, B, N, d, chunks_per_split, skip, c);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  merge_kernel<<<(unsigned)((B + WARPS - 1) / WARPS), THREADS, 0, s>>>(
      ps, pp, static_cast<float*>(out_s), static_cast<int*>(out_p), B, splits, c);
  return (int)cudaGetLastError();
}
