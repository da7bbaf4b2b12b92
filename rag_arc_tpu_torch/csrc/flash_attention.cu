// Causal, segment-masked attention forward for Hopper (sm_90a).
//
// Replaces the library Pallas kernel that rag_arc_tpu/models/qwen3.py
// calls on the TPU (jax.experimental.pallas.ops.tpu.flash_attention with
// SegmentIds(q=seg, kv=seg), causal=True; qwen3.py:176-196). Inputs q
// (B, H, L, D), k and v (B, HKV, L, D) with HKV dividing H, of one dtype,
// contiguous; seg (B, L) int32. Query head h reads KV head h / (H / HKV)
// directly: no GQA repeat in memory. Query i attends key j iff
// seg[i] == seg[j] and (when causal) j <= i. The output (B, H, L, D) in
// the input dtype is written through its strides (sB, sH, sL; the last
// axis dense), so a (B, L, H, D) buffer seen as (B, H, L, D) takes it in
// place. The (B, H, L, L) scores never leave the chip.
//
// Rounding points (those of the plain version, ops/flash_attention.py):
// Q·Kᵀ accumulates in f32; the softmax runs in f32 with a running row max
// m and row sum l; the unnormalized probabilities exp(s - m) are rounded
// to bf16 for P·V, which accumulates in f32; l sums the f32 probabilities;
// out = acc / l, rounded once.
//
// What bounds it on an H100: at B=64, H=16/HKV=8, L=512, D=128 the causal
// half is ~69 GFLOP (0.07 ms at 989 TFLOP/s) against ~403 MB of Q, K, V
// and output (0.12 ms at 3.35 TB/s): bytes, if each byte moves once.
//
// The bf16 design (D in {64, 128}):
//
// - A block is one producer warp and two consumer warpgroups, each owning
//   64 query rows of one head. (The producer warp heads a warpgroup of
//   its own, whose other three warps only hand their registers over.)
//   Where group = H / HKV is even, the two warpgroups take the same 64
//   rows of two query heads that share a KV head, so every K/V tile that
//   arrives is used twice; otherwise they take 128 consecutive rows of
//   one head.
// - The grid is persistent (one block per SM) and walks the work units
//   with the query tiles that have the most causal work first.
// - Q comes by TMA once per unit; K and V come in 64-key tiles by TMA
//   through a 3-stage ring with full/empty mbarriers. The tensor maps are
//   3D (D, L, B*heads), so the ragged end of L is zero-filled by the
//   hardware and never reads the next head's rows. The producer warp's
//   lanes also stage each tile's 64 key segment ids.
// - S = Q·Kᵀ is wgmma m64n64k16 with Q and K from shared memory (K-major,
//   128-byte swizzle). P·V is wgmma m64nDk16 with P from registers: the S
//   accumulator's layout is the A fragment's, so each 16-key slice of P
//   is four bf16x2 registers packed from S; V comes from shared memory
//   through the descriptor's transpose bit (MN-major B).
// - The online softmax, the mask and the rescaling of the O accumulator
//   stay in registers; key tiles wholly above the causal diagonal are
//   never loaded.
// - A row with no allowed key so far keeps m = -inf; the exponentials
//   then subtract 0, never -inf, so an empty tile gives 0, not NaN. Every
//   row meets its own key under the causal rule, so pad rows of
//   left-padded batches come out finite.
// - setmaxnreg: the block starts at 168 registers a thread (384 x 168
//   fills the register file); the producer warpgroup drops to 40, and the
//   128 x 128 registers it frees take each consumer thread to 232.
// - The epilogue writes O / l straight through the output's strides.
//
// f32 inputs take a SIMT kernel (one warp per query row, no tensor
// cores), so that f32 models run on the card too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;               // query rows per consumer warpgroup
constexpr int BN = 64;               // keys per K/V tile
constexpr int STAGES = 3;
constexpr int CONSUMERS = 256;       // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup (one warp loads)
constexpr int TILE = 64 * 64 * 2;    // one 64 x 64 bf16 sub-tile (a 64-wide d block)
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct FLayout {
  static constexpr int DB = D / 64;              // 64-wide d blocks
  static constexpr int Q_BYTES = 2 * DB * TILE;  // both warpgroups' Q
  static constexpr int KV_BYTES = DB * TILE;     // one K or one V tile
  static constexpr int SEG = 1024;               // 64 key segment ids, padded to 1 KB
  static constexpr int STAGE = 2 * KV_BYTES + SEG;
  static constexpr int BARS = (2 + 2 * STAGES) * 8;
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE + BARS;  // + alignment slack
};

struct Params {
  const int* seg;
  __nv_bfloat16* out;
  long long sB, sH, sL;  // output strides, elements
  int B, H, HKV, L;
  float scale_log2;
  int causal;
  int pair;     // group even: the two warpgroups take two heads of one KV head
  int n_qt;     // query tiles per head (64 rows paired, 128 rows otherwise)
  int per_qt;   // work units per query tile
  int total;    // work units
};

// One block's unit of work: batch row b, KV head kvh, and for each
// consumer warpgroup its query head and first query row.
struct Unit {
  int b, kvh, h[2], q0[2];
};

__device__ __forceinline__ Unit decode(const Params& p, int u) {
  Unit un;
  const int qt = p.n_qt - 1 - u / p.per_qt;  // the most causal work first
  const int r = u % p.per_qt;
  const int group = p.H / p.HKV;
  if (p.pair) {
    const int pairs = group / 2;
    un.b = r / (p.HKV * pairs);
    const int r2 = r % (p.HKV * pairs);
    un.kvh = r2 / pairs;
    un.h[0] = un.kvh * group + 2 * (r2 % pairs);
    un.h[1] = un.h[0] + 1;
    un.q0[0] = un.q0[1] = qt * BM;
  } else {
    un.b = r / p.H;
    un.h[0] = un.h[1] = r % p.H;
    un.kvh = un.h[0] / group;
    un.q0[0] = qt * 2 * BM;
    un.q0[1] = un.q0[0] + BM;
  }
  return un;
}

// K/V tiles a warpgroup whose rows start at q0 needs.
__device__ __forceinline__ int n_tiles(const Params& p, int q0) {
  const int all = (p.L + BN - 1) / BN;
  return p.causal ? min(all, q0 / BN + 1) : all;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int D>
__device__ __forceinline__ void pv_wgmma(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t b);

template <>
__device__ __forceinline__ void pv_wgmma<128>(float (&o)[64], const uint32_t (&a)[4],
                                              uint64_t b) {
  hopper::wgmma_m64n128k16_rs(o, a, b, 1);
}

template <>
__device__ __forceinline__ void pv_wgmma<64>(float (&o)[32], const uint32_t (&a)[4],
                                             uint64_t b) {
  hopper::wgmma_m64n64k16_rs(o, a, b, 1);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const Params p) {
  using Lay = FLayout<D>;
  constexpr int DB = Lay::DB;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* qs = smem;                      // [warpgroup][d block][64 rows][64]
  unsigned char* ring = smem + Lay::Q_BYTES;     // stages of [K][V][segment ids]
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + STAGES * Lay::STAGE);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  uint64_t* full = bars + 2;
  uint64_t* empty = full + STAGES;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, CONSUMERS / 32);  // lane 0 of each consumer warp
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full[s], 32);            // every producer lane
      hopper::mbar_init(&empty[s], CONSUMERS / 32);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer warpgroup: it hands its registers to the consumers
    // (setmaxnreg works on whole warpgroups); its first warp loads
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x >= CONSUMERS + 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      hopper::prefetch_map(&qmap);
      hopper::prefetch_map(&kmap);
      hopper::prefetch_map(&vmap);
    }
    int stage = 0;
    uint32_t phase = 0, qphase = 0;
    for (int u = blockIdx.x; u < p.total; u += gridDim.x) {
      const Unit un = decode(p, u);
      const int n = max(n_tiles(p, un.q0[0]), n_tiles(p, un.q0[1]));
      if (lane == 0) {
        hopper::mbar_wait(q_empty, qphase ^ 1);
        hopper::mbar_arrive_expect_tx(q_full, Lay::Q_BYTES);
        for (int w = 0; w < 2; ++w)
          for (int db = 0; db < DB; ++db)
            hopper::tma_load_3d(qs + (w * DB + db) * TILE, &qmap, q_full, db * 64, un.q0[w],
                                un.b * p.H + un.h[w]);
      }
      qphase ^= 1;
      const int kv_row = un.b * p.HKV + un.kvh;
      for (int kt = 0; kt < n; ++kt) {
        hopper::mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = ring + stage * Lay::STAGE;
        int* kseg = reinterpret_cast<int*>(st + 2 * Lay::KV_BYTES);
        for (int i = lane; i < BN; i += 32) {
          const int key = kt * BN + i;
          kseg[i] = key < p.L ? p.seg[(long long)un.b * p.L + key] : 0;
        }
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(&full[stage], 2 * Lay::KV_BYTES);
          for (int db = 0; db < DB; ++db) {
            hopper::tma_load_3d(st + db * TILE, &kmap, &full[stage], db * 64, kt * BN, kv_row);
            hopper::tma_load_3d(st + Lay::KV_BYTES + db * TILE, &vmap, &full[stage], db * 64,
                                kt * BN, kv_row);
          }
        } else {
          hopper::mbar_arrive(&full[stage]);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg, its warp wi holds query rows
  // q0 + 16 wi + lane / 4 (+ 8)
  hopper::setmaxnreg_inc<232>();
  const int wg = threadIdx.x / 128;
  const int wi = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int t4 = lane % 4;
  const uint32_t q_addr = hopper::smem_u32(qs + wg * DB * TILE);
  int stage = 0;
  uint32_t phase = 0, qphase = 0;

  for (int u = blockIdx.x; u < p.total; u += gridDim.x) {
    const Unit un = decode(p, u);
    const int n = max(n_tiles(p, un.q0[0]), n_tiles(p, un.q0[1]));
    const int mine = n_tiles(p, un.q0[wg]);
    const int h = un.h[wg];
    int row[2], qseg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row[r] = un.q0[wg] + wi * 16 + lane / 4 + 8 * r;
      qseg[r] = row[r] < p.L ? p.seg[(long long)un.b * p.L + row[r]] : 0;
    }
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY};
    float lsum[2] = {0.0f, 0.0f};  // this thread's share of each row's sum

    hopper::mbar_wait(q_full, qphase);
    qphase ^= 1;
    for (int kt = 0; kt < n; ++kt) {
      hopper::mbar_wait(&full[stage], phase);
      if (kt < mine) {
        unsigned char* st = ring + stage * Lay::STAGE;
        const uint32_t k_addr = hopper::smem_u32(st);
        const uint32_t v_addr = k_addr + Lay::KV_BYTES;
        const int* kseg = reinterpret_cast<const int*>(st + 2 * Lay::KV_BYTES);

        // S = Q Kᵀ (64 rows x 64 keys)
        float s[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] = 0.0f;
        hopper::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const uint32_t off = (ks / 4) * TILE + (ks % 4) * 32;
          hopper::wgmma_m64n64k16_ss(s, hopper::desc_sw128(q_addr + off, 16, 1024),
                                     hopper::desc_sw128(k_addr + off, 16, 1024), ks > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(s);
        if (kt == mine - 1 && lane == 0) hopper::mbar_arrive(q_empty);  // Q read for good

        // mask, scale to the log2 domain, online softmax
        const int k0 = kt * BN;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int2 kk = *reinterpret_cast<const int2*>(kseg + 8 * j + 2 * t4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = i / 2;
            const int key = k0 + 8 * j + 2 * t4 + (i % 2);
            const int ksg = (i % 2) ? kk.y : kk.x;
            const bool ok = key < p.L && (!p.causal || key <= row[r]) && ksg == qseg[r];
            s[4 * j + i] = ok ? s[4 * j + i] * p.scale_log2 : -INFINITY;
            mx[r] = fmaxf(mx[r], s[4 * j + i]);
          }
        }
        float alpha[2], m_use[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m[r], mx[r]);
          m_use[r] = m_new == -INFINITY ? 0.0f : m_new;  // no -inf - -inf
          alpha[r] = exp2f(m[r] - m_use[r]);              // 0 while m was -inf
          m[r] = m_new;
          lsum[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[i] = exp2f(s[i] - m_use[(i / 2) % 2]);  // masked: exp2(-inf) = 0
          lsum[(i / 2) % 2] += s[i];
        }
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j + 0] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }

        // O += P V: the 16-key slice c of P as the A fragment, straight
        // from the S accumulator
        uint32_t pa[4][4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          pa[c][0] = pack_bf16(s[8 * c + 0], s[8 * c + 1]);
          pa[c][1] = pack_bf16(s[8 * c + 2], s[8 * c + 3]);
          pa[c][2] = pack_bf16(s[8 * c + 4], s[8 * c + 5]);
          pa[c][3] = pack_bf16(s[8 * c + 6], s[8 * c + 7]);
        }
        hopper::wgmma_fence();
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // V rows (keys) 16c.. as the K dimension: 1024 bytes per 8 keys,
          // 64-wide d blocks TILE bytes apart
          pv_wgmma<D>(o, pa[c], hopper::desc_sw128(v_addr + c * 16 * 128, TILE, 1024));
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(o);
      }
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= p.L) continue;
      const float l = lsum[r] > 0.0f ? lsum[r] : 1.0f;
      __nv_bfloat16* orow = p.out + un.b * p.sB + h * p.sH + row[r] * p.sL;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const __nv_bfloat162 v2 =
            __floats2bfloat162_rn(o[4 * j + 2 * r] / l, o[4 * j + 2 * r + 1] / l);
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + t4 * 2) = v2;
      }
    }
  }
}

// ----------------------------------------------------------------- f32 --

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

constexpr int F_WARPS = 4;

// One warp per query row: lane j scores key j0 + j of each 32-key chunk,
// then every lane accumulates D/32 output columns over the chunk. Query
// head h reads KV head h / (H / HKV).
template <int D>
__global__ void __launch_bounds__(F_WARPS * 32)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ seg,
                 float* __restrict__ out, long long BH, int H, int HKV, int L, long long sB,
                 long long sH, long long sL, float scale_log2, bool causal) {
  constexpr int E = D / 32;
  __shared__ float qrow[F_WARPS][D];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * F_WARPS + warp;  // bh * L + i
  if (row >= BH * L) return;  // whole warps exit together
  const long long bh = row / L;
  const int i = (int)(row % L);
  const long long b = bh / H;
  const int h = (int)(bh % H);
  for (int e = lane; e < D; e += 32) qrow[warp][e] = q[row * D + e];
  __syncwarp();
  const int si = seg[b * L + i];
  const long long kvh = b * HKV + h / (H / HKV);
  const float* kb = k + kvh * L * D;
  const float* vb = v + kvh * L * D;
  float m = -INFINITY, lsum = 0.0f, acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0f;
  const int jend = causal ? i + 1 : L;
  for (int j0 = 0; j0 < jend; j0 += 32) {
    const int j = j0 + lane;
    float sc = -INFINITY;
    if (j < jend && seg[b * L + j] == si) {
      const float* kr = kb + (long long)j * D;
      float dot = 0.0f;
      for (int e = 0; e < D; ++e) dot = fmaf(qrow[warp][e], kr[e], dot);
      sc = dot * scale_log2;
    }
    const float m_new = fmaxf(m, warp_max(sc));
    const float m_use = m_new == -INFINITY ? 0.0f : m_new;
    const float alpha = exp2f(m - m_use);
    const float p = exp2f(sc - m_use);
    lsum = lsum * alpha + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= alpha;
    const int n = min(32, jend - j0);
    for (int tt = 0; tt < n; ++tt) {
      const float pt = __shfl_sync(0xffffffffu, p, tt);
      const float* vr = vb + (long long)(j0 + tt) * D;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = fmaf(pt, vr[lane + 32 * e], acc[e]);
    }
  }
  const float l = lsum > 0.0f ? lsum : 1.0f;
  float* orow = out + b * sB + h * sH + i * sL;
#pragma unroll
  for (int e = 0; e < E; ++e) orow[lane + 32 * e] = acc[e] / l;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const int* seg, void* out, int B,
                int H, int HKV, int L, long long sB, long long sH, long long sL,
                float scale_log2, bool causal, cudaStream_t s) {
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorInvalidValue;  // TMA needs 16-byte-aligned bases
  CUtensorMap qmap, kmap, vmap;
  const uint64_t qdims[3] = {(uint64_t)D, (uint64_t)L, (uint64_t)B * H};
  const uint64_t kdims[3] = {(uint64_t)D, (uint64_t)L, (uint64_t)B * HKV};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)L * D * 2};
  const uint32_t box[3] = {64, 64, 1};
  if (!hopper::make_map_bf16(&qmap, q, 3, qdims, strides, box) ||
      !hopper::make_map_bf16(&kmap, k, 3, kdims, strides, box) ||
      !hopper::make_map_bf16(&vmap, v, 3, kdims, strides, box))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.seg = seg;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.sB = sB;
  p.sH = sH;
  p.sL = sL;
  p.B = B;
  p.H = H;
  p.HKV = HKV;
  p.L = L;
  p.scale_log2 = scale_log2;
  p.causal = causal ? 1 : 0;
  const int group = H / HKV;
  p.pair = group % 2 == 0 ? 1 : 0;
  p.n_qt = p.pair ? (L + BM - 1) / BM : (L + 2 * BM - 1) / (2 * BM);
  p.per_qt = p.pair ? B * HKV * (group / 2) : B * H;
  const long long total = (long long)p.n_qt * p.per_qt;
  if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.total = (int)total;
  const int smem = FLayout<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (int)(total < hopper::sm_count() ? total : hopper::sm_count());
  flash_wgmma_kernel<D><<<grid, THREADS, smem, s>>>(qmap, kmap, vmap, p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const int* seg, void* out, int B,
               int H, int HKV, int L, long long sB, long long sH, long long sL,
               float scale_log2, bool causal, cudaStream_t s) {
  const long long rows = (long long)B * H * L;
  const long long blocks = (rows + F_WARPS - 1) / F_WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_f32_kernel<D><<<(unsigned)blocks, F_WARPS * 32, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      seg, static_cast<float*>(out), (long long)B * H, H, HKV, L, sB, sH, sL, scale_log2,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16; D in
// {64, 128}; HKV divides H; sm_scale multiplies Q·Kᵀ; sB, sH, sL are the
// output's strides in elements (its last axis dense). The caller
// guarantees contiguous q, k, v and seg of the shapes above (bf16: q, k, v
// 16-byte aligned, else cudaErrorInvalidValue). Launches on `stream`,
// does not synchronise, and returns the CUDA error of the launch (0 on
// success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* seg, void* out, int B, int H, int HKV,
                                      int L, int D, long long sB, long long sH, long long sL,
                                      float sm_scale, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sg = static_cast<const int*>(seg);
  const float scale_log2 = sm_scale * LOG2E;
  const bool c = causal != 0;
  if (HKV <= 0 || H % HKV != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && D == 128)
    return launch_bf16<128>(q, k, v, sg, out, B, H, HKV, L, sB, sH, sL, scale_log2, c, s);
  if (dtype == 1 && D == 64)
    return launch_bf16<64>(q, k, v, sg, out, B, H, HKV, L, sB, sH, sL, scale_log2, c, s);
  if (dtype == 0 && D == 128)
    return launch_f32<128>(q, k, v, sg, out, B, H, HKV, L, sB, sH, sL, scale_log2, c, s);
  if (dtype == 0 && D == 64)
    return launch_f32<64>(q, k, v, sg, out, B, H, HKV, L, sB, sH, sL, scale_log2, c, s);
  return (int)cudaErrorInvalidValue;
}
