// Fused MIPS + top-k for Hopper (sm_90a): (B, k) scores and positions with
// no (B, N) score matrix in device memory.
//
// Replaces rag_arc_tpu/ops/fused_mips.py:50 _fused_kernel (fused_mips_topk).
// The TPU kernel walks the corpus tiles in order on one core and folds each
// tile's scores into a running (B, k) list in VMEM. Blocks on a GPU run in
// no order, so here a grid of (corpus split x query block) keeps running
// lists in shared memory and merge_kernel (one warp per query) merges the
// splits' lists.
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
// What bounds it on an H100: the 2*B*N*d operations of the scores (the
// corpus is read once, B*N scores never leave the SM), compute-bound at
// B = 512. The design keeps the tensor cores busy and the top-k work off
// their path (bf16):
//
// - A block is a producer warpgroup (one thread issues TMA loads into a
//   4-stage full/empty mbarrier ring of 64-wide d slices, 128-byte
//   swizzle; setmaxnreg leaves it 40 registers and the consumers 232) and
//   two consumer warpgroups. A tile is 64 corpus rows x the block's query
//   block of QB = 128 (64 for k > 64, so that the lists fit), one
//   m64nQBk16 wgmma accumulator (corpus = A, queries = B). A block keeps
//   one query block for its whole corpus split, so its running lists stay
//   in shared memory; blocks of one split and different query blocks are
//   neighbours in the grid, so they co-run and the corpus streams from HBM
//   about once. The grid fills the SMs once (splits x query blocks).
// - Warpgroup ping-pong: the consumers take alternate tiles. Ordered named
//   barriers let one issue its mainloop (one wgmma group in flight) while
//   the other runs the epilogue of the tile before, and order the
//   epilogues, which share the lists.
// - Epilogue in registers: score, l2 (-((qsq - 2 dot) + sqnorm), in that
//   rounding order), the valid mask (loaded before the mainloop) and the
//   packed quantization (the identity when packing is off), then the test
//   against the column's threshold theta, the k-th score of its running
//   list read once per tile. A score >= theta survives: ties with theta
//   too, since in packed order a later column of the same tile beats an
//   equal quantized score; the fold applies the exact order. Only
//   survivors leave registers, into a per-query candidate buffer in shared
//   memory. A tile has 64 rows, so a query takes at most 64 candidates
//   from it: the buffer holds them all and nothing is dropped, also on a
//   split's first tiles, where theta is the empty slot's NEG and every
//   live score survives. theta only rises, so the filter is exact. The
//   per-value code is a few instructions: the epilogue is unrolled over
//   the thread's 64 values, and with the full order test inlined in each
//   it took several times as long as the mainloop.
// - Fold: each warp finds its queries with candidates by one ballot and
//   folds them into their sorted lists (a ballot picks the next candidate
//   above the k-th under the total order; its slot is the count of entries
//   that rank above it; the tail shifts down), under the other
//   warpgroup's wgmma.
//
// skip_tiles (the TPU's threshold early exit) does not change the result,
// and both values take the filter path here. f32 stays on CUDA cores (no
// TF32, which would change rankings against the f32 reference): 128-row
// chunks through a cp.async ring into a score slab, folded by warps.
//
// The bf16 operands must suit TMA: 16-byte-aligned bases and d % 8 == 0;
// the f32 ones 16-byte rows and bases (the wrapper copies an operand that
// is not into aligned, zero-padded storage).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG = -3.0e38f;
constexpr int KMAX = 128;
constexpr int KPL = KMAX / 32;  // list entries per lane
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may take

struct Ctx {
  int k;
  int tile_n;
  int packed;    // 1: the packed order and quantized scores
  int low_mask;  // (1 << idx_bits) - 1
};

// a ranks strictly above b; an empty slot (position < 0) ranks below all
__device__ __forceinline__ bool beats(float as, int ap, float bs, int bp, const Ctx& c) {
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
__device__ __forceinline__ void insert(float* ls, int* lp, float s, int p, const Ctx& c,
                                       int lane) {
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
__device__ __forceinline__ void fold_above(float* ls, int* lp, float (&cs)[NC], int (&cp)[NC],
                                           const Ctx& c, int lane) {
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

// ---------------------------------------------------------------- bf16 --

constexpr int W_ROWS = 64;     // corpus rows per tile: one warpgroup's m64
constexpr int W_KT = 64;       // d slice per stage: one 128-byte swizzle row
constexpr int W_STAGES = 4;
constexpr int W_CONSUMERS = 256;  // two consumer warpgroups
constexpr int W_THREADS = W_CONSUMERS + 128;  // + a producer warpgroup
constexpr int CAP = W_ROWS;    // candidates a query can take from one tile

// named barriers (0 is __syncthreads, used once before the roles split)
constexpr int BAR_TURN = 1;  // + wg: warpgroup wg may issue its mainloop
constexpr int BAR_EPI = 3;   // + wg: warpgroup wg may run its epilogue
constexpr int BAR_WG = 5;    // + wg: inside one warpgroup's epilogue
constexpr int BAR_DONE = 7;  // both warpgroups are done with the split

// Shared memory: ring | candidates (scores, positions) | counts | qsq |
// mbarriers | lists (scores, positions).
template <int QB>
struct WLayout {
  static constexpr int X_BYTES = W_ROWS * W_KT * 2;
  static constexpr int STAGE = X_BYTES + QB * W_KT * 2;  // a multiple of 1024
  static constexpr int RING = W_STAGES * STAGE;
  static constexpr int CAND = QB * CAP * 8;
  static constexpr int FIXED = 1024 + RING + CAND + QB * 8 + 2 * W_STAGES * 8;
  static constexpr int smem(int k) { return FIXED + QB * k * 8; }
};

template <int QB>
__device__ __forceinline__ void mma(float (&acc)[QB / 2], uint64_t a, uint64_t b, int sd) {
  if constexpr (QB == 64) hopper::wgmma_m64n64k16_ss(acc, a, b, sd);
  else hopper::wgmma_m64n128k16_ss(acc, a, b, sd);
}

template <int QB, bool L2>
__global__ void __launch_bounds__(W_THREADS, 1)
fused_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap qmap, const uint8_t* __restrict__ valid,
                   const float* __restrict__ qsq, const float* __restrict__ sqnorm,
                   float* __restrict__ part_s, int* __restrict__ part_p, int B, int N, int d,
                   int per, Ctx c) {
  using Lay = WLayout<QB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* cand_s = reinterpret_cast<float*>(smem + Lay::RING);  // [QB][CAP]
  int* cand_p = reinterpret_cast<int*>(cand_s + QB * CAP);
  int* count = cand_p + QB * CAP;  // candidates per query
  float* qsq_s = reinterpret_cast<float*>(count + QB);
  uint64_t* full = reinterpret_cast<uint64_t*>(qsq_s + QB);
  uint64_t* empty = full + W_STAGES;
  float* lists_s = reinterpret_cast<float*>(empty + W_STAGES);  // [QB][k], sorted
  int* lists_p = reinterpret_cast<int*>(lists_s + QB * c.k);

  const int n_qblk = (B + QB - 1) / QB;
  const int b0 = (blockIdx.x % n_qblk) * QB;
  const int split = blockIdx.x / n_qblk;
  const int t0 = split * per;  // the split's first 64-row tile
  const int n_local = max(0, min((N + W_ROWS - 1) / W_ROWS, t0 + per) - t0);
  const int n_k = (d + W_KT - 1) / W_KT;

  for (int i = threadIdx.x; i < QB * c.k; i += W_THREADS) {
    lists_s[i] = NEG;
    lists_p[i] = -1;
  }
  for (int i = threadIdx.x; i < QB; i += W_THREADS) {
    count[i] = 0;
    qsq_s[i] = L2 && b0 + i < B ? qsq[b0 + i] : 0.0f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < W_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);  // lane 0 of each warp of the one reader
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= W_CONSUMERS) {
    // ---- producer warpgroup: one thread keeps the ring full, in tile order
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == W_CONSUMERS) {
      hopper::prefetch_map(&xmap);
      hopper::prefetch_map(&qmap);
      long slice = 0;
      for (int i = 0; i < n_local; ++i) {
        const int r0 = (t0 + i) * W_ROWS;
        for (int ks = 0; ks < n_k; ++ks, ++slice) {
          const int stage = (int)(slice % W_STAGES);
          hopper::mbar_wait(&empty[stage], (uint32_t)((slice / W_STAGES) & 1) ^ 1);
          unsigned char* st = smem + stage * Lay::STAGE;
          hopper::mbar_arrive_expect_tx(&full[stage], Lay::STAGE);
          hopper::tma_load_2d(st, &xmap, &full[stage], ks * W_KT, r0);
          hopper::tma_load_2d(st + Lay::X_BYTES, &qmap, &full[stage], ks * W_KT, b0);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes the split's tiles wg, wg + 2, ...
  hopper::setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;  // owns rows [16 warp, 16 warp + 16) of a tile
  const int lane = threadIdx.x % 32;
  float acc[QB / 2];

  for (int i = wg; i < n_local; i += 2) {
    const int r0 = (t0 + i) * W_ROWS;
    // what the epilogue reads of global memory, loaded before the mainloop:
    // this thread's rows r_lo and r_lo + 8, their mask and (l2) sqnorm
    const int r_lo = r0 + warp * 16 + lane / 4;
    const int r_hi = r_lo + 8;
    const bool v_lo = r_lo < N && valid[r_lo];
    const bool v_hi = r_hi < N && valid[r_hi];
    const float sq_lo = L2 && v_lo ? sqnorm[r_lo] : 0.0f;
    const float sq_hi = L2 && v_hi ? sqnorm[r_hi] : 0.0f;

    // mainloop, in turn with the other warpgroup
    if (i >= 1) hopper::named_barrier_sync(BAR_TURN + wg, W_CONSUMERS);
    long slice = (long)i * n_k;
    int prev = 0;
    for (int ks = 0; ks < n_k; ++ks, ++slice) {
      const int stage = (int)(slice % W_STAGES);
      hopper::mbar_wait(&full[stage], (uint32_t)((slice / W_STAGES) & 1));
      const uint32_t xa = hopper::smem_u32(smem + stage * Lay::STAGE);
      const uint32_t qa = xa + Lay::X_BYTES;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < W_KT / 16; ++kk) {
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
    if (i + 1 < n_local) hopper::named_barrier_arrive(BAR_TURN + (wg ^ 1), W_CONSUMERS);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    if (lane == 0) hopper::mbar_arrive(&empty[prev]);

    // epilogue, in turn with the other warpgroup (the lists are shared).
    // acc[4j + 2h + e] is row (h ? r_hi : r_lo), column 8j + 2 (lane % 4) + e
    if (i >= 1) hopper::named_barrier_sync(BAR_EPI + wg, W_CONSUMERS);
#pragma unroll
    for (int j = 0; j < QB / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * (lane % 4) + e;
        const bool live = b0 + col < B;
        const float theta = lists_s[col * c.k + c.k - 1];
        const float q2 = L2 ? qsq_s[col] : 0.0f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float s = acc[4 * j + 2 * h + e];
          if (L2) s = -((q2 - 2.0f * s) + (h ? sq_hi : sq_lo));
          s = quantize(s, c.low_mask);
          if (live && (h ? v_hi : v_lo) && s >= theta) {
            const int slot = atomicAdd(&count[col], 1);  // < CAP: 64 rows a tile
            cand_s[col * CAP + slot] = s;
            cand_p[col * CAP + slot] = h ? r_hi : r_lo;
          }
        }
      }
    }
    hopper::named_barrier_sync(BAR_WG + wg, 128);
    // fold: warp w takes queries w + 4 l (l < QB / 4 <= 32), those with
    // candidates found by one ballot
    const int mine = warp + 4 * lane < QB ? count[warp + 4 * lane] : 0;
    for (unsigned todo = __ballot_sync(0xffffffffu, mine > 0); todo; todo &= todo - 1) {
      const int src = __ffs(todo) - 1;
      const int col = warp + 4 * src;
      const int n = __shfl_sync(0xffffffffu, mine, src);
      float cs[2];
      int cp[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int idx = lane + 32 * t;
        cs[t] = idx < n ? cand_s[col * CAP + idx] : NEG;
        cp[t] = idx < n ? cand_p[col * CAP + idx] : -1;
      }
      fold_above<2>(lists_s + col * c.k, lists_p + col * c.k, cs, cp, c, lane);
      if (lane == 0) count[col] = 0;
    }
    if (i + 1 < n_local) hopper::named_barrier_arrive(BAR_EPI + (wg ^ 1), W_CONSUMERS);
  }

  hopper::named_barrier_sync(BAR_DONE, W_CONSUMERS);
  for (int i = threadIdx.x; i < QB * c.k; i += W_CONSUMERS) {
    const int b = b0 + i / c.k;
    if (b >= B) continue;
    const long o = ((long)split * B + b) * c.k + i % c.k;
    part_s[o] = lists_s[i];
    part_p[o] = lists_p[i];
  }
}

// ----------------------------------------------------------------- f32 --

constexpr int F_WARPS = 8;
constexpr int F_THREADS = F_WARPS * 32;
constexpr int F_ROWS = 128;          // rows per chunk: thread t owns rows t % 32 + 32 i
constexpr int F_QB = 64;             // queries per block
constexpr int F_QPW = F_QB / F_WARPS;  // queries folded per warp
constexpr int KB = 64;               // bytes of a row per k-step
constexpr int PITCH = KB + 16;       // staged row pitch in bytes
constexpr int F_STAGES = 3;
constexpr int F_X_BYTES = F_ROWS * PITCH;
constexpr int F_STAGE = F_X_BYTES + F_QB * PITCH;
constexpr int LDR = F_ROWS + 4;      // slab[query][row]
constexpr int SLAB_BYTES = F_QB * LDR * 4;

__host__ __device__ constexpr int f32_smem(int k) {
  return F_STAGES * F_STAGE + SLAB_BYTES + F_QB * k * 8;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes)
               : "memory");
}

// One k-step of copies (64 bytes of each of the chunk's 128 corpus rows and
// the block's 64 query rows), row-major at an 80-byte pitch.
__device__ __forceinline__ void issue_kstep(unsigned char* st, const unsigned char* x,
                                            const unsigned char* q, long r0, int b0, int N,
                                            int B, long row_bytes, int ks, int tid) {
  const long kbyte = (long)ks * KB;
#pragma unroll
  for (int i = 0; i < (F_ROWS * 4) / F_THREADS; ++i) {
    const int c = tid + i * F_THREADS;
    const int r = c >> 2, ch = c & 3;
    const long row = r0 + r;
    const long off = kbyte + ch * 16;
    const bool ok = row < N && off < row_bytes;
    cp_async16(st + r * PITCH + ch * 16, ok ? x + row * row_bytes + off : x, ok ? 16 : 0);
  }
  const int r = tid >> 2, ch = tid & 3;
  const long qrow = b0 + r;
  const long off = kbyte + ch * 16;
  const bool ok = qrow < B && off < row_bytes;
  cp_async16(st + F_X_BYTES + r * PITCH + ch * 16, ok ? q + qrow * row_bytes + off : q,
             ok ? 16 : 0);
}

// Thread t owns rows (t % 32) + 32 i, i < 4, and queries (t / 32) * 8 + j,
// j < 8, of the 128 x 64 chunk: 16-byte reads of a row by neighbouring
// threads fall in distinct bank groups (80-byte pitch), a query's are a
// broadcast.
__global__ void __launch_bounds__(F_THREADS, 2)
fused_f32_kernel(const float* __restrict__ qf, const float* __restrict__ xf,
                 const uint8_t* __restrict__ valid, const float* __restrict__ qsq,
                 const float* __restrict__ sqnorm, float* __restrict__ part_s,
                 int* __restrict__ part_p, int B, int N, int d, int per, Ctx c) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  float* slab = reinterpret_cast<float*>(smem + F_STAGES * F_STAGE);
  float* lists_s = reinterpret_cast<float*>(smem + F_STAGES * F_STAGE + SLAB_BYTES);
  int* lists_p = reinterpret_cast<int*>(lists_s + F_QB * c.k);

  const int n_qblk = (B + F_QB - 1) / F_QB;
  const int b0 = (blockIdx.x % n_qblk) * F_QB;
  const int split = blockIdx.x / n_qblk;
  const int c0 = split * per;
  const int my_chunks = max(0, min((N + F_ROWS - 1) / F_ROWS, c0 + per) - c0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tr = tid & 31, tq = tid >> 5;
  const long row_bytes = (long)d * 4;
  const int ksteps = (int)((row_bytes + KB - 1) / KB);
  const unsigned char* x = reinterpret_cast<const unsigned char*>(xf);
  const unsigned char* q = reinterpret_cast<const unsigned char*>(qf);

  for (int i = tid; i < F_QB * c.k; i += F_THREADS) {
    lists_s[i] = NEG;
    lists_p[i] = -1;
  }

  const long total = (long)my_chunks * ksteps;
#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < total)
      issue_kstep(ring + s * F_STAGE, x, q, (long)(c0 + s / ksteps) * F_ROWS, b0, N, B,
                  row_bytes, s % ksteps, tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  float a[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) a[i][j] = 0.0f;
  for (long s = 0; s < total; ++s) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();  // k-step s has landed for all; stage s-1 is free
    const long nxt = s + F_STAGES - 1;
    if (nxt < total)
      issue_kstep(ring + (nxt % F_STAGES) * F_STAGE, x, q, (long)(c0 + nxt / ksteps) * F_ROWS,
                  b0, N, B, row_bytes, (int)(nxt % ksteps), tid);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    const unsigned char* st = ring + (s % F_STAGES) * F_STAGE;
#pragma unroll
    for (int kk = 0; kk < KB; kk += 16) {
      float4 xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        xv[i] = *reinterpret_cast<const float4*>(st + (tr + 32 * i) * PITCH + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 qv = *reinterpret_cast<const float4*>(st + F_X_BYTES + (tq * 8 + j) * PITCH + kk);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = a[i][j];
          v = fmaf(xv[i].x, qv.x, v);
          v = fmaf(xv[i].y, qv.y, v);
          v = fmaf(xv[i].z, qv.z, v);
          v = fmaf(xv[i].w, qv.w, v);
          a[i][j] = v;
        }
      }
    }
    if ((s + 1) % ksteps) continue;

    // the chunk's scores are complete: through the slab into the lists
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        slab[(tq * 8 + j) * LDR + tr + 32 * i] = a[i][j];
        a[i][j] = 0.0f;
      }
    __syncthreads();
    const long r0 = (long)(c0 + s / ksteps) * F_ROWS;
    for (int qq = 0; qq < F_QPW; ++qq) {
      const int qi = warp * F_QPW + qq;
      const int b = b0 + qi;
      if (b >= B) break;
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
      fold_above<4>(lists_s + qi * c.k, lists_p + qi * c.k, cs, cpos, c, lane);
    }
    // the slab is written again only after the next chunk's k-steps, each
    // of which starts with __syncthreads
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  for (int i = tid; i < F_QB * c.k; i += F_THREADS) {
    const int b = b0 + i / c.k;
    if (b >= B) continue;
    const long o = ((long)split * B + b) * c.k + i % c.k;
    part_s[o] = lists_s[i];
    part_p[o] = lists_p[i];
  }
}

// --------------------------------------------------------------- merge --

constexpr int M_WARPS = 8;

// one warp per query: the top k of the union of the splits' lists
__global__ void __launch_bounds__(M_WARPS * 32)
merge_kernel(const float* __restrict__ part_s, const int* __restrict__ part_p,
             float* __restrict__ out_s, int* __restrict__ out_p, int B, int splits, Ctx c) {
  __shared__ float ls_all[M_WARPS][KMAX];
  __shared__ int lp_all[M_WARPS][KMAX];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.x * M_WARPS + warp;
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

template <int QB, bool L2>
int launch_wgmma(const void* q, const void* x, const uint8_t* v, const float* qs,
                 const float* sq, float* ps, int* pp, int B, int N, int d, int splits, int per,
                 const Ctx& c, cudaStream_t s) {
  // TMA: 16-byte-aligned bases, row strides a multiple of 16 bytes
  if (d % 8 != 0 || (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(x)) % 16)
    return (int)cudaErrorInvalidValue;
  const int smem = WLayout<QB>::smem(c.k);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, qmap;
  const uint64_t xdims[2] = {(uint64_t)d, (uint64_t)N}, qdims[2] = {(uint64_t)d, (uint64_t)B};
  const uint64_t stride[1] = {(uint64_t)d * 2};
  const uint32_t xbox[2] = {W_KT, W_ROWS}, qbox[2] = {W_KT, QB};
  if (!hopper::make_map_bf16(&xmap, x, 2, xdims, stride, xbox) ||
      !hopper::make_map_bf16(&qmap, q, 2, qdims, stride, qbox))
    return (int)cudaErrorInvalidValue;
  auto kernel = fused_wgmma_kernel<QB, L2>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)(((B + QB - 1) / QB) * splits);
  kernel<<<grid, W_THREADS, smem, s>>>(xmap, qmap, v, qs, sq, ps, pp, B, N, d, per, c);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16. qsq (B,)
// and sqnorm (N,) f32 select the l2 score -((qsq - 2 q.x) + sqnorm); both
// null otherwise. part_s/part_p are (splits, B, k) scratch, out_s/out_p the
// (B, k) result. The schedule is the wrapper's (ops/fused_mips.py
// ::schedule): `splits` corpus splits of `per` tiles (64 rows for bf16,
// 128 for f32) covering N, and the bf16 query block qb in {64, 128}. The
// caller guarantees contiguous device buffers, 1 <= k <= 128, for bf16
// 16-byte-aligned q and x and d % 8 == 0, for f32 16-byte rows and bases
// (else cudaErrorInvalidValue). Launches both kernels on `stream`, does not
// synchronise, and returns the CUDA error of the launches (0 on success).
extern "C" int fused_mips_launch(const void* q, const void* x, const void* valid,
                                 const void* qsq, const void* sqnorm, void* part_s, void* part_p,
                                 void* out_s, void* out_p, int B, int N, int d, int k,
                                 int tile_n, int packed, int idx_bits, int splits, int per,
                                 int qb, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > KMAX || B <= 0 || splits < 1 || per < 1) return (int)cudaErrorInvalidValue;
  if ((qsq == nullptr) != (sqnorm == nullptr)) return (int)cudaErrorInvalidValue;
  const Ctx c{k, tile_n, packed, packed ? (int)((1u << idx_bits) - 1u) : 0};
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const float* qs = static_cast<const float*>(qsq);
  const float* sq = static_cast<const float*>(sqnorm);
  float* ps = static_cast<float*>(part_s);
  int* pp = static_cast<int*>(part_p);
  int err;
  if (dtype == 1) {
    const bool l2 = sq != nullptr;
    if (qb == 128 && l2) err = launch_wgmma<128, true>(q, x, v, qs, sq, ps, pp, B, N, d, splits, per, c, s);
    else if (qb == 128) err = launch_wgmma<128, false>(q, x, v, qs, sq, ps, pp, B, N, d, splits, per, c, s);
    else if (qb == 64 && l2) err = launch_wgmma<64, true>(q, x, v, qs, sq, ps, pp, B, N, d, splits, per, c, s);
    else if (qb == 64) err = launch_wgmma<64, false>(q, x, v, qs, sq, ps, pp, B, N, d, splits, per, c, s);
    else err = (int)cudaErrorInvalidValue;
  } else if (dtype == 0) {
    if ((d * 4) % 16 || (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(x)) % 16)
      return (int)cudaErrorInvalidValue;
    const int smem = f32_smem(k);
    err = (int)cudaFuncSetAttribute(fused_f32_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == 0) {
      const unsigned grid = (unsigned)(((B + F_QB - 1) / F_QB) * splits);
      fused_f32_kernel<<<grid, F_THREADS, smem, s>>>(static_cast<const float*>(q),
                                                     static_cast<const float*>(x), v, qs, sq,
                                                     ps, pp, B, N, d, per, c);
      err = (int)cudaGetLastError();
    }
  } else {
    err = (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  merge_kernel<<<(unsigned)((B + M_WARPS - 1) / M_WARPS), M_WARPS * 32, 0, s>>>(
      ps, pp, static_cast<float*>(out_s), static_cast<int*>(out_p), B, splits, c);
  return (int)cudaGetLastError();
}
