// Fused attention prep for Hopper (sm_90a): per-head qk-RMSNorm + RoPE +
// (B, L, H*D) -> (B, H, L, D) transpose (+ GQA repeat of K and V).
//
// Replaces the TPU kernel rag_arc_tpu/ops/rope_prep.py::_kernel (reached
// through rope_prep). Inputs are the projection layouts: q (B, L, NH*D),
// k and v (B, L, NKV*D), each row (b, l) starting `ld` elements after the
// previous one (a column slice of the fused qkv projection needs no
// copy); cos_full and sin_signed (B, L, D) f32; optional per-head RMS-norm
// scales qs, ks (D,) f32. Outputs are contiguous (B, H, L, D) tensors in
// the input dtype: Q with NH heads; K and V with NH heads when `repeat`
// (written once per query head of their group: the GQA repeat of the JAX
// kernel happens at write time), else with NKV heads, each written once
// (the model's path: flash attention reads the KV heads directly).
//
//   x'  = qs * x * rsqrt(mean(x^2) + eps)          (f32; skipped without qs)
//   out = x' * cos_full + roll(x', D/2) * sin_signed, rounded once
//
// What bounds it on an H100: bytes. It does a few FLOPs per element and,
// at the reranker's shape (B=64, L=512, NH/NKV = 16/8, D=128, bf16),
// reads ~300 MB (q, k, v, and the f32 tables once per (b, l)) and writes
// ~400 MB with the repeat (K and V twice each) or ~270 MB without: ~0.21
// or ~0.17 ms a layer at 3.35 TB/s. The design
// makes one pass over each tensor: one warp per (b, l, kv head) loads its
// rows with vector loads, keeps every intermediate in registers, and
// writes each output row as one contiguous D-row. The eight warps of a
// block are consecutive kv heads of one (b, l), so they share the cos/sin
// row through L1.
//
// Lane layout: lane i holds elements [i*E, i*E + E) with E = D/32 (4 at
// D=128, 2 at D=64). The rope partner of element e is e ^ (D/2), which
// sits at the same slot of lane i ^ 16: one __shfl_xor_sync gives it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 8 warps, one (b, l, kv head) each
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// E elements of T as one aligned vector
template <typename T, int E>
struct alignas(sizeof(T) * E) Pack {
  T v[E];
};

template <typename T, int E>
__device__ __forceinline__ Pack<T, E> load_pack(const T* p, bool vec) {
  Pack<T, E> pk;
  if (vec) {
    pk = *reinterpret_cast<const Pack<T, E>*>(p);
  } else {
#pragma unroll
    for (int j = 0; j < E; ++j) pk.v[j] = p[j];
  }
  return pk;
}

// Outputs are contiguous and 256-byte aligned at the base, and each lane's
// offset is a multiple of E: always vector stores.
template <typename T, int E>
__device__ __forceinline__ void store_pack(T* p, const Pack<T, E>& pk) {
  *reinterpret_cast<Pack<T, E>*>(p) = pk;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Normalizes (if scale) and rotates one head row held as x[E] per lane.
template <int D, int E>
__device__ __forceinline__ void norm_rope(float (&x)[E], const float (&c)[E],
                                          const float (&s)[E],
                                          const float* __restrict__ scale,
                                          int lane, float eps) {
  if (scale != nullptr) {
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < E; ++j) ss += x[j] * x[j];
    const float r = rsqrtf(warp_sum(ss) / (float)D + eps);
#pragma unroll
    for (int j = 0; j < E; ++j) x[j] = x[j] * r * scale[lane * E + j];
  }
  float partner[E];
#pragma unroll
  for (int j = 0; j < E; ++j) partner[j] = __shfl_xor_sync(0xffffffffu, x[j], 16);
#pragma unroll
  for (int j = 0; j < E; ++j) x[j] = x[j] * c[j] + partner[j] * s[j];
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
rope_prep_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ cosf,
                 const float* __restrict__ sinf, const float* __restrict__ qs,
                 const float* __restrict__ ks, T* __restrict__ qo,
                 T* __restrict__ ko, T* __restrict__ vo, long long q_ld,
                 long long k_ld, long long v_ld, int B, int L, int NH,
                 int NKV, float eps, bool vec, bool repeat) {
  constexpr int E = D / 32;
  const int lane = threadIdx.x % 32;
  const long long w = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (w >= (long long)B * L * NKV) return;  // whole warps exit together
  const int kvh = (int)(w % NKV);
  const long long bl = w / NKV;  // b * L + l
  const long long b = bl / L;
  const long long l = bl % L;
  const int group = NH / NKV;
  const int e0 = lane * E;

  float c[E], s[E];
  {
    const Pack<float, E> cp = load_pack<float, E>(cosf + bl * D + e0, vec);
    const Pack<float, E> sp = load_pack<float, E>(sinf + bl * D + e0, vec);
#pragma unroll
    for (int j = 0; j < E; ++j) {
      c[j] = cp.v[j];
      s[j] = sp.v[j];
    }
  }

  // out[(b, h, l, :)] of a (B, H, L, D) tensor
  auto out_row = [&](T* base, int H, int h) {
    return base + ((b * H + h) * L + l) * D + e0;
  };

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const Pack<T, E> in = load_pack<T, E>(q + bl * q_ld + (long long)h * D + e0, vec);
    float x[E];
#pragma unroll
    for (int j = 0; j < E; ++j) x[j] = to_f32(in.v[j]);
    norm_rope<D, E>(x, c, s, qs, lane, eps);
    Pack<T, E> o;
#pragma unroll
    for (int j = 0; j < E; ++j) o.v[j] = from_f32<T>(x[j]);
    store_pack<T, E>(out_row(qo, NH, h), o);
  }

  {
    const Pack<T, E> in = load_pack<T, E>(k + bl * k_ld + (long long)kvh * D + e0, vec);
    float x[E];
#pragma unroll
    for (int j = 0; j < E; ++j) x[j] = to_f32(in.v[j]);
    norm_rope<D, E>(x, c, s, ks, lane, eps);
    Pack<T, E> o;
#pragma unroll
    for (int j = 0; j < E; ++j) o.v[j] = from_f32<T>(x[j]);
    const Pack<T, E> vv = load_pack<T, E>(v + bl * v_ld + (long long)kvh * D + e0, vec);
    if (repeat) {
      for (int g = 0; g < group; ++g) {
        store_pack<T, E>(out_row(ko, NH, kvh * group + g), o);
        store_pack<T, E>(out_row(vo, NH, kvh * group + g), vv);  // V is copied as is
      }
    } else {
      store_pack<T, E>(out_row(ko, NKV, kvh), o);
      store_pack<T, E>(out_row(vo, NKV, kvh), vv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const float* cosf,
           const float* sinf, const float* qs, const float* ks, void* qo,
           void* ko, void* vo, long long q_ld, long long k_ld, long long v_ld,
           int B, int L, int NH, int NKV, float eps, bool vec, bool repeat,
           cudaStream_t stream) {
  const long long warps = (long long)B * L * NKV;
  const long long blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rope_prep_kernel<T, D><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), cosf, sinf, qs, ks, static_cast<T*>(qo),
      static_cast<T*>(ko), static_cast<T*>(vo), q_ld, k_ld, v_ld, B, L, NH,
      NKV, eps, vec, repeat);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16; D in
// {64, 128}; qs and ks both null (no norm) or both set. `vec` says that
// every q/k/v/cos/sin row start is aligned for a D/32-element vector
// load; `repeat` picks NH-headed (1) or NKV-headed (0) K and V outputs.
// The caller guarantees the layouts above, NH % NKV == 0 and contiguous
// cos/sin. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 on success).
extern "C" int rope_prep_launch(const void* q, const void* k, const void* v,
                                const void* cosf, const void* sinf,
                                const void* qs, const void* ks, void* qo,
                                void* ko, void* vo, long long q_ld,
                                long long k_ld, long long v_ld, int B, int L,
                                int NH, int NKV, int D, float eps, int vec,
                                int repeat, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cosf);
  const float* sn = static_cast<const float*>(sinf);
  const float* qsc = static_cast<const float*>(qs);
  const float* ksc = static_cast<const float*>(ks);
  if ((qsc == nullptr) != (ksc == nullptr) || NKV <= 0 || NH % NKV != 0)
    return (int)cudaErrorInvalidValue;
  const bool vv = vec != 0, rep = repeat != 0;
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, c, sn, qsc, ksc, qo, ko, vo, q_ld,
                                      k_ld, v_ld, B, L, NH, NKV, eps, vv, rep, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, c, sn, qsc, ksc, qo, ko, vo, q_ld,
                                     k_ld, v_ld, B, L, NH, NKV, eps, vv, rep, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, c, sn, qsc, ksc, qo, ko, vo, q_ld, k_ld,
                              v_ld, B, L, NH, NKV, eps, vv, rep, s);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, c, sn, qsc, ksc, qo, ko, vo, q_ld, k_ld,
                             v_ld, B, L, NH, NKV, eps, vv, rep, s);
  return (int)cudaErrorInvalidValue;
}
