// Causal, segment-masked attention forward for Hopper (sm_90a).
//
// Replaces the library Pallas kernel that rag_arc_tpu/models/qwen3.py
// calls on the TPU (jax.experimental.pallas.ops.tpu.flash_attention with
// SegmentIds(q=seg, kv=seg), causal=True; qwen3.py:176-196). Inputs q, k,
// v (B, H, L, D) of one dtype, contiguous; seg (B, L) int32. Query i
// attends key j iff seg[i] == seg[j] and (when causal) j <= i. Output
// (B, H, L, D) in the input dtype. The (B, H, L, L) scores never leave
// the chip: at the reranker's shape (B=64, H=16, L=512) they would be
// 1 GiB of f32 a layer, written and read back.
//
// Rounding points (those of the plain version, ops/flash_attention.py):
// Q·Kᵀ accumulates in f32; the softmax runs in f32 with a running row max
// m and row sum l; the unnormalized probabilities exp(s - m) are rounded
// to bf16 for P·V, which accumulates in f32; l sums the f32 probabilities;
// out = acc / l, rounded once.
//
// What bounds it on an H100: at B=64, H=16, L=512, D=128 the causal half
// is ~69 GFLOP against ~270 MB of Q, K, V and output, ~250 FLOP a byte,
// near the card's ridge (~295 in bf16), so the tensor cores are the roof.
// This first design is simple and right, not yet fast:
//
// - one block per (b*h, 64-query tile), 4 warps of 16 query rows; tiles
//   with more causal work are scheduled first;
// - Q·Kᵀ and P·V on the tensor cores with mma.sync m16n8k16 bf16 -> f32,
//   fragments loaded from shared memory with ldmatrix (V with .trans);
// - 64-key K and V tiles staged in shared memory, rows padded by 16 bytes
//   so ldmatrix reads hit distinct banks; key tiles wholly above the
//   causal diagonal are skipped;
// - the online softmax stays in registers: the S accumulator's layout is
//   the P operand's, so P never goes through shared memory, and each
//   thread's rows are known, so rescaling the output accumulator by
//   exp(m_old - m_new) is a register multiply;
// - a row with no allowed key so far keeps m = -inf; the exponentials
//   then subtract 0, never -inf, so an empty tile gives 0, not NaN. Every
//   row meets its own key under the causal rule, so pad rows of
//   left-padded batches come out finite.
//
// TMA loads, wgmma, a pipelined K/V ring and reading the KV heads
// directly (no GQA repeat in memory) are later work.
//
// f32 inputs take a SIMT kernel (one warp per query row, no tensor
// cores), so that f32 models run on the card too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per K/V tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int lds() {
  return D + 8;  // padded smem row, in bf16 elements
}

template <int D>
__host__ __device__ constexpr size_t smem_bytes() {
  return (size_t)(BQ + 2 * BK) * lds<D>() * sizeof(__nv_bfloat16) + BK * sizeof(int);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&h);
}

// Copies rows [row0, row0 + 64) of a (L, D) bf16 matrix into smem rows of
// lds<D>() elements, zero rows past L (a zero V row keeps 0 * V finite).
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int L, bool vec) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < 64 * CPR; c += THREADS) {
    const int r = c / CPR;
    const int col = (c % CPR) * 8;
    __nv_bfloat16* d = dst + r * lds<D>() + col;
    const int row = row0 + r;
    if (row < L) {
      const __nv_bfloat16* s = src + (long long)row * D + col;
      if (vec) {
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) d[i] = s[i];
      }
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const int* __restrict__ seg, __nv_bfloat16* __restrict__ out,
                  int H, int L, float scale_log2, bool causal) {
  constexpr int LDS = lds<D>();
  constexpr int KC = D / 16;  // 16-wide d chunks of Q·Kᵀ
  constexpr int NO = D / 8;   // 8-wide d tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + BQ * LDS;
  __nv_bfloat16* vs = ks + BK * LDS;
  int* kseg = reinterpret_cast<int*>(vs + BK * LDS);

  const int n_qt = (L + BQ - 1) / BQ;
  const long long bh = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);  // most work first
  const int q0 = qt * BQ;
  const long long b = bh / H;
  const long long base = bh * (long long)L * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;  // fragment row (and row + 8)
  const int t = lane % 4;  // fragment column pair
  const bool vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) % 16) == 0;

  load_tile<D>(qs, q + base, q0, L, vec);
  __syncthreads();

  // this warp's 16 query rows as A fragments, one per 16-wide d chunk
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    ldmatrix_x4(qf[kc], qs + (warp * 16 + lane % 16) * LDS + kc * 16 + (lane / 16) * 8);
  }

  int qi[2], qseg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    qi[r] = q0 + warp * 16 + g + 8 * r;
    qseg[r] = qi[r] < L ? seg[b * L + qi[r]] : 0;
  }

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY};
  float lsum[2] = {0.0f, 0.0f};  // this thread's share of each row's sum

  const int n_kt_all = (L + BK - 1) / BK;
  const int n_kt = causal ? min(n_kt_all, qt + 1) : n_kt_all;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(ks, k + base, k0, L, vec);
    load_tile<D>(vs, v + base, k0, L, vec);
    for (int j = threadIdx.x; j < BK; j += THREADS) {
      kseg[j] = k0 + j < L ? seg[b * L + k0 + j] : 0;
    }
    __syncthreads();

    // S = Q Kᵀ: 8 tiles of 8 keys, each 16 rows x 8 keys
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];  // b0, b1 of key tile 2np, then of 2np + 1
        ldmatrix_x4(bk, ks + (np * 16 + (lane % 8) + (lane / 16) * 8) * LDS + kc * 16 +
                            ((lane / 8) % 2) * 8);
        mma_bf16(s[2 * np], qf[kc], bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qf[kc], bk[2], bk[3]);
      }
    }

    // mask, scale to the log2 domain, online softmax
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i / 2;
        const int jj = n * 8 + t * 2 + (i % 2);  // key within the tile
        const int kj = k0 + jj;
        const bool ok = kj < L && (!causal || kj <= qi[r]) && kseg[jj] == qseg[r];
        s[n][i] = ok ? s[n][i] * scale_log2 : -INFINITY;
        mx[r] = fmaxf(mx[r], s[n][i]);
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
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = exp2f(s[n][i] - m_use[i / 2]);  // masked: exp2(-inf) = 0
        lsum[i / 2] += s[n][i];
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V: P (16 rows x 64 keys) as four 16-key A fragments straight
    // from the S accumulators, V tiles through ldmatrix.trans
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * c][0], s[2 * c][1]);
      pa[1] = pack_bf16(s[2 * c][2], s[2 * c][3]);
      pa[2] = pack_bf16(s[2 * c + 1][0], s[2 * c + 1][1]);
      pa[3] = pack_bf16(s[2 * c + 1][2], s[2 * c + 1][3]);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t bv[4];  // b0, b1 of d tile 2dp, then of 2dp + 1
        ldmatrix_x4_trans(bv, vs + (c * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * LDS +
                                  dp * 16 + (lane / 16) * 8);
        mma_bf16(o[2 * dp], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= L) continue;
    const float l = lsum[r] > 0.0f ? lsum[r] : 1.0f;
    __nv_bfloat16* orow = out + base + (long long)qi[r] * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(o[n][2 * r] / l, o[n][2 * r + 1] / l);
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + t * 2) = h;
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

// One warp per query row: lane j scores key j0 + j of each 32-key chunk,
// then every lane accumulates D/32 output columns over the chunk.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ seg,
                 float* __restrict__ out, long long BH, int H, int L,
                 float scale_log2, bool causal) {
  constexpr int E = D / 32;
  __shared__ float qrow[WARPS][D];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * WARPS + warp;  // bh * L + i
  if (row >= BH * L) return;  // whole warps exit together
  const long long bh = row / L;
  const int i = (int)(row % L);
  const long long b = bh / H;
  for (int e = lane; e < D; e += 32) qrow[warp][e] = q[row * D + e];
  __syncwarp();
  const int si = seg[b * L + i];
  const float* kb = k + bh * L * D;
  const float* vb = v + bh * L * D;
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
#pragma unroll
  for (int e = 0; e < E; ++e) out[row * D + lane + 32 * e] = acc[e] / l;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const int* seg, void* out,
                int B, int H, int L, float scale_log2, bool causal, cudaStream_t s) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * H * ((L + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_bf16_kernel<D><<<(unsigned)blocks, THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), seg, static_cast<__nv_bfloat16*>(out), H, L,
      scale_log2, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const int* seg, void* out,
               int B, int H, int L, float scale_log2, bool causal, cudaStream_t s) {
  const long long rows = (long long)B * H * L;
  const long long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_f32_kernel<D><<<(unsigned)blocks, THREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), seg, static_cast<float*>(out), (long long)B * H, H, L,
      scale_log2, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16; D in
// {64, 128}; sm_scale multiplies Q·Kᵀ. The caller guarantees contiguous
// device buffers of the shapes above. Launches on `stream`, does not
// synchronise, and returns the CUDA error of the launch (0 on success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      const void* seg, void* out, int B, int H, int L,
                                      int D, float sm_scale, int causal, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sg = static_cast<const int*>(seg);
  const float scale_log2 = sm_scale * LOG2E;
  const bool c = causal != 0;
  if (dtype == 1 && D == 128) return launch_bf16<128>(q, k, v, sg, out, B, H, L, scale_log2, c, s);
  if (dtype == 1 && D == 64) return launch_bf16<64>(q, k, v, sg, out, B, H, L, scale_log2, c, s);
  if (dtype == 0 && D == 128) return launch_f32<128>(q, k, v, sg, out, B, H, L, scale_log2, c, s);
  if (dtype == 0 && D == 64) return launch_f32<64>(q, k, v, sg, out, B, H, L, scale_log2, c, s);
  return (int)cudaErrorInvalidValue;
}
