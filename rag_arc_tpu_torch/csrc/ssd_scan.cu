// The Mamba-2 state-space scan (SSD), segment-resetting, chunked, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no state-space model. It was
// added for models/granite_hybrid.py (Granite 4.0-H's Mamba-2 mixers); the
// function, the chunked form and the rounding points are those of
// ops/ssd_scan.py's docstring and ssd_scan_plain. Inputs: xbc (R, L,
// H·64 + 2·N) bf16, contiguous, the convolved [x | B | C]; dt (R, L, H) bf16
// through a token stride (a column slice of the mixer's input projection);
// A_log, dt_bias, D (H,) f32; seg (R, L) int32, −1 on padding. Output y
// (R, L, H·64) bf16, zero on padding.
//
// What bounds it on an H100: per token and head ~5·P·N FLOPs (the chunk's
// four products) against ~4·P bytes of x and y. At 28 rows of 512 and 128
// heads of P = 64, N = 128 that is ~0.11 ms of bf16 tensor-core work
// against ~0.14 ms of x read and y written at 3.35 TB/s: near the ridge,
// bytes first, if x is read and y written once.
//
// The design:
//
// - A block is one (head, row), four warps; the grid puts the heads of a
//   row next to each other, so the row's B and C (shared by every head)
//   come from L2 after the first head reads them. The block walks the
//   row's chunks of Q = 64 tokens in order and keeps the head's P × N f32
//   state in registers (each warp 16 of its 64 rows, as the accumulator
//   of the state-update product), so the state never touches device
//   memory.
// - Each chunk stages C and B (token-major), B and x transposed, and a
//   bf16 copy of the carried state in shared memory, with rows padded by
//   16 bytes so that the fragment loads meet no bank conflict; warp 0
//   computes the steps, their prefix sums (a warp scan) and each token's
//   decay to the chunk's end.
// - Four products on mma.sync m16n8k16 (bf16 operands, f32 sums), each
//   warp owning 16 query tokens: the carried term C·Hᵀ (the state rounded
//   to bf16 for the product), C·Bᵀ masked to s <= t of t's own live
//   segment and weighted by exp(cum_t − cum_s)·dt_s, whose accumulator is
//   repacked in registers as the A operand of W·x (as flash attention
//   reuses its scores), and the state update xsᵀ·B with xs = x·decay·dt
//   rounded to bf16. Tiles wholly above the causal diagonal are skipped;
//   the carried term is skipped where no segment holds a state.
// - y = W·x + [held]·exp(cum_t)·C·H + D·x is written once, as bf16 pairs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int P = 64;        // channels a head
constexpr int N = 128;       // state channels (d_state)
constexpr int Q = 64;        // tokens a chunk
constexpr int THREADS = 128; // four warps, 16 tokens (or state rows) each
constexpr int TS = Q + 8;    // row stride (bf16) of the transposed tiles
constexpr int CS = N + 8;    // row stride (bf16) of C, B and the state

struct Smem {
  __nv_bfloat16 c[Q * CS];          // C, [t][n]
  __nv_bfloat16 b[Q * CS];          // B, [s][n]
  __nv_bfloat16 bt[N * TS];         // B transposed, [n][s]
  __nv_bfloat16 xt[P * TS];         // x transposed, [p][s]
  __nv_bfloat16 st[P * CS];         // the carried state rounded to bf16, [p][n]
  float cum[Q];                     // prefix sums of dt·A from the chunk's start
  float step[Q];                    // dt, 0 on padding
  float to_end[Q];                  // exp(cum_end − cum_s)·dt_s within the end segment, else 0
  int seg[Q];                       // segment ids, −1 past the row's end
};

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&h);
}

// a bf16 pair times two f32 factors, rounded back to a bf16 pair
__device__ __forceinline__ uint32_t scale_pair(uint32_t v, float lo, float hi) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
  return pack_bf16(__bfloat162float(h.x) * lo, __bfloat162float(h.y) * hi);
}

__global__ void __launch_bounds__(THREADS, 2)
ssd_scan_kernel(const __nv_bfloat16* __restrict__ xbc, const __nv_bfloat16* __restrict__ dt,
                const float* __restrict__ a_log, const float* __restrict__ dt_bias,
                const float* __restrict__ dvec, const int* __restrict__ segs,
                __nv_bfloat16* __restrict__ y, int L, int H, long long dt_stride) {
  constexpr int NT = N / 8;  // 8-wide state column tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int h = blockIdx.x;
  const int r = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // fragment row
  const int tq = lane % 4;  // fragment column pair
  const int t0 = warp * 16; // this warp's tokens, and its rows of the state
  const long long width = (long long)H * P + 2 * N;
  const float a = -expf(a_log[h]);
  const float dtb = dt_bias[h];
  const float dh = dvec[h];

  float state[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) state[nt][0] = state[nt][1] = state[nt][2] = state[nt][3] = 0.f;
  int prev = -1;  // the segment that holds the state at the chunk's start

  for (int c0 = 0; c0 < L; c0 += Q) {
    const long long tok0 = (long long)r * L + c0;
    const int len = min(L - c0, Q);
    // ---- stage the chunk: C token-major (coalesced 16-byte loads)
    for (int v = threadIdx.x; v < Q * (N / 8); v += THREADS) {
      const int s = v / (N / 8), n0 = (v % (N / 8)) * 8;
      uint4 cv = make_uint4(0, 0, 0, 0);
      if (s < len) {
        cv = *reinterpret_cast<const uint4*>(xbc + (tok0 + s) * width + (long long)H * P + N +
                                             n0);
      }
      *reinterpret_cast<uint4*>(&sm.c[s * CS + n0]) = cv;
    }
    // B both ways, and x transposed: a warp takes 32 consecutive tokens of
    // one column block, so its 2-byte stores fill 16 consecutive words
    for (int v = threadIdx.x; v < Q * (N / 8); v += THREADS) {
      const int s = v % Q, n0 = (v / Q) * 8;
      uint4 bv = make_uint4(0, 0, 0, 0);
      if (s < len) {
        bv = *reinterpret_cast<const uint4*>(xbc + (tok0 + s) * width + (long long)H * P + n0);
      }
      *reinterpret_cast<uint4*>(&sm.b[s * CS + n0]) = bv;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&bv);
#pragma unroll
      for (int i = 0; i < 8; ++i) sm.bt[(n0 + i) * TS + s] = e[i];
    }
    for (int v = threadIdx.x; v < Q * (P / 8); v += THREADS) {
      const int s = v % Q, p0 = (v / Q) * 8;
      uint4 xv = make_uint4(0, 0, 0, 0);
      if (s < len) xv = *reinterpret_cast<const uint4*>(xbc + (tok0 + s) * width + h * P + p0);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&xv);
#pragma unroll
      for (int i = 0; i < 8; ++i) sm.xt[(p0 + i) * TS + s] = e[i];
    }
    // ---- steps and their prefix sums: warp 0, two tokens a lane
    if (warp == 0) {
      float st2[2];
      int sg2[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = 2 * lane + i;
        sg2[i] = -1;
        st2[i] = 0.f;
        if (t < len) {
          sg2[i] = segs[tok0 + t];
          const float raw = __bfloat162float(dt[(tok0 + t) * dt_stride + h]) + dtb;
          const float sp = raw > 20.f ? raw : log1pf(expf(raw));
          st2[i] = sg2[i] >= 0 ? sp : 0.f;
        }
      }
      const float lo = st2[0] * a;
      float incl = lo + st2[1] * a;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += o;
      }
      const float excl = incl - (lo + st2[1] * a);
      sm.cum[2 * lane] = excl + lo;
      sm.cum[2 * lane + 1] = incl;
      sm.step[2 * lane] = st2[0];
      sm.step[2 * lane + 1] = st2[1];
      sm.seg[2 * lane] = sg2[0];
      sm.seg[2 * lane + 1] = sg2[1];
      __syncwarp();
      const int end_seg = sm.seg[len - 1];
      const float cum_end = sm.cum[len - 1];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = 2 * lane + i;
        sm.to_end[t] = (sg2[i] >= 0 && sg2[i] == end_seg) ? expf(cum_end - sm.cum[t]) * st2[i]
                                                         : 0.f;
      }
    }
    __syncthreads();

    const int end_seg = sm.seg[len - 1];
    const float cum_end = sm.cum[len - 1];
    const int ta = t0 + g, tb = t0 + g + 8;  // this lane's two tokens
    const int sa = sm.seg[ta], sb = sm.seg[tb];
    const float ca = sm.cum[ta], cb = sm.cum[tb];

    // ---- the carried term, for the tokens of the segment that holds it
    float acc[P / 8][4];
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    if (prev >= 0) {
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const int k = kk * 16 + 2 * tq;
        const uint32_t a0 = ld32(&sm.c[ta * CS + k]), a1 = ld32(&sm.c[tb * CS + k]);
        const uint32_t a2 = ld32(&sm.c[ta * CS + k + 8]), a3 = ld32(&sm.c[tb * CS + k + 8]);
#pragma unroll
        for (int nt = 0; nt < P / 8; ++nt) {
          const __nv_bfloat16* bp = &sm.st[(nt * 8 + g) * CS + k];
          mma(acc[nt], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
        }
      }
      const float ha = (sa >= 0 && sa == prev) ? expf(ca) : 0.f;
      const float hb = (sb >= 0 && sb == prev) ? expf(cb) : 0.f;
#pragma unroll
      for (int nt = 0; nt < P / 8; ++nt) {
        acc[nt][0] *= ha;
        acc[nt][1] *= ha;
        acc[nt][2] *= hb;
        acc[nt][3] *= hb;
      }
    }

    // ---- C·Bᵀ over this warp's 16 tokens and the chunk's 64, masked and
    // weighted; tiles wholly above the diagonal stay zero
    float w[Q / 8][4];
#pragma unroll
    for (int nt = 0; nt < Q / 8; ++nt) w[nt][0] = w[nt][1] = w[nt][2] = w[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const int k = kk * 16 + 2 * tq;
      const uint32_t a0 = ld32(&sm.c[ta * CS + k]), a1 = ld32(&sm.c[tb * CS + k]);
      const uint32_t a2 = ld32(&sm.c[ta * CS + k + 8]), a3 = ld32(&sm.c[tb * CS + k + 8]);
#pragma unroll
      for (int nt = 0; nt < Q / 8; ++nt) {
        if (nt <= 2 * warp + 1) {
          const __nv_bfloat16* bp = &sm.b[(nt * 8 + g) * CS + k];
          mma(w[nt], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < Q / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int s = nt * 8 + 2 * tq + j;
        const int ss = sm.seg[s];
        const float cs = sm.cum[s], dts = sm.step[s];
        const bool ok_a = sa >= 0 && ss == sa && s <= ta;
        const bool ok_b = sb >= 0 && ss == sb && s <= tb;
        w[nt][j] = ok_a ? w[nt][j] * expf(ca - cs) * dts : 0.f;
        w[nt][2 + j] = ok_b ? w[nt][2 + j] * expf(cb - cs) * dts : 0.f;
      }
    }

    // ---- y += W·x, W's accumulator repacked as the A operand in bf16
#pragma unroll
    for (int kj = 0; kj < Q / 16; ++kj) {
      if (kj <= warp) {
        const uint32_t a0 = pack_bf16(w[2 * kj][0], w[2 * kj][1]);
        const uint32_t a1 = pack_bf16(w[2 * kj][2], w[2 * kj][3]);
        const uint32_t a2 = pack_bf16(w[2 * kj + 1][0], w[2 * kj + 1][1]);
        const uint32_t a3 = pack_bf16(w[2 * kj + 1][2], w[2 * kj + 1][3]);
        const int k = kj * 16 + 2 * tq;
#pragma unroll
        for (int nt = 0; nt < P / 8; ++nt) {
          const __nv_bfloat16* bp = &sm.xt[(nt * 8 + g) * TS + k];
          mma(acc[nt], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
        }
      }
    }

    // ---- y += D·x, zero on padding, written once as bf16 pairs
#pragma unroll
    for (int nt = 0; nt < P / 8; ++nt) {
      const int p = nt * 8 + 2 * tq;
      if (ta < len) {
        const float y0 = sa >= 0 ? acc[nt][0] + dh * __bfloat162float(sm.xt[p * TS + ta]) : 0.f;
        const float y1 =
            sa >= 0 ? acc[nt][1] + dh * __bfloat162float(sm.xt[(p + 1) * TS + ta]) : 0.f;
        *reinterpret_cast<uint32_t*>(y + (tok0 + ta) * H * P + h * P + p) = pack_bf16(y0, y1);
      }
      if (tb < len) {
        const float y0 = sb >= 0 ? acc[nt][2] + dh * __bfloat162float(sm.xt[p * TS + tb]) : 0.f;
        const float y1 =
            sb >= 0 ? acc[nt][3] + dh * __bfloat162float(sm.xt[(p + 1) * TS + tb]) : 0.f;
        *reinterpret_cast<uint32_t*>(y + (tok0 + tb) * H * P + h * P + p) = pack_bf16(y0, y1);
      }
    }

    // ---- the state of the chunk's last token's segment, carried on:
    // rows t0..t0+15 of state = keep·exp(cum_end)·state + xsᵀ·B
    const float keep = (end_seg == prev && prev >= 0) ? expf(cum_end) : 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      state[nt][0] *= keep;
      state[nt][1] *= keep;
      state[nt][2] *= keep;
      state[nt][3] *= keep;
    }
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
      const int k = kk * 16 + 2 * tq;
      const float e0 = sm.to_end[k], e1 = sm.to_end[k + 1];
      const float e8 = sm.to_end[k + 8], e9 = sm.to_end[k + 9];
      const uint32_t a0 = scale_pair(ld32(&sm.xt[(t0 + g) * TS + k]), e0, e1);
      const uint32_t a1 = scale_pair(ld32(&sm.xt[(t0 + g + 8) * TS + k]), e0, e1);
      const uint32_t a2 = scale_pair(ld32(&sm.xt[(t0 + g) * TS + k + 8]), e8, e9);
      const uint32_t a3 = scale_pair(ld32(&sm.xt[(t0 + g + 8) * TS + k + 8]), e8, e9);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* bp = &sm.bt[(nt * 8 + g) * TS + k];
        mma(state[nt], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
      }
    }
    prev = end_seg;
    __syncthreads();  // every warp is done with this chunk's tiles
    if (c0 + Q < L) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = nt * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(&sm.st[(t0 + g) * CS + n]) =
            pack_bf16(state[nt][0], state[nt][1]);
        *reinterpret_cast<uint32_t*>(&sm.st[(t0 + g + 8) * CS + n]) =
            pack_bf16(state[nt][2], state[nt][3]);
      }
    }
  }
}

}  // namespace

// head_dim 64, d_state 128. Returns a CUDA error code (0 = launched).
extern "C" int ssd_scan_launch(const void* xbc, const void* dt, const void* a_log,
                               const void* dt_bias, const void* d, const void* seg, void* y,
                               int R, int L, int H, long long dt_stride, void* stream) {
  const int bytes = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<<<dim3(H, R), THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xbc), static_cast<const __nv_bfloat16*>(dt),
      static_cast<const float*>(a_log), static_cast<const float*>(dt_bias),
      static_cast<const float*>(d), static_cast<const int*>(seg),
      static_cast<__nv_bfloat16*>(y), L, H, dt_stride);
  return (int)cudaGetLastError();
}
