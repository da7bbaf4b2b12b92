// IVF probe scan for Hopper (sm_90a): the masked scores of every row of
// every list a query probes, each probed list read once for all the
// queries that probe it.
//
//   out[b, p * Lmax + r] = valid[c, r] ? score(b, c, r) : -inf,  c = probe[b, p]
//   dot  = sum_i qc[b, i] * x[c, r, i]                 (f32 accumulation)
//   score = dot                                        (cosine / ip)
//         = -((q_sq[b] - 2 dot) + sqnorm[c, r])        (l2)
//         = cross[b, c] + dot * sqnorm[c, r]           (int8 residual codes,
//                                                       sqnorm = row scale)
//
// qc is the query already rounded to the list dtype (bf16 for int8 codes)
// and widened to f32 by the wrapper, so kernel and plain version multiply
// the same values; bf16 and int8 products are exact in f32.
//
// Replaces the probe gather and scoring of rag_arc_tpu/index/ivf.py
// (_ivf_search_body, :768-812; an XLA program, no Pallas). The TPU body
// took care to read the probed lists in place (a vmapped dynamic_slice),
// because an XLA gather staged GBs of copies; in PyTorch `lists[probe]` is
// that copy, a (B, nprobe, Lmax, d) tensor. This kernel keeps the
// property: its only output is the (B, nprobe * Lmax) f32 score buffer.
//
// What bounds it on an H100: bytes. Each probed list must be read once,
// for 2 * d operations per row and query: far below the ~295 operations a
// byte where the tensor cores would become the limit, but at 768 f32 FMAs
// a row and query the CUDA cores fall behind HBM once a list's group
// passes a few queries (2.6 a list on average at B = 32, nprobe 8; 82 at
// B = 1024, nprobe 8, the size of one recall-search dispatch).
//
// Two paths, chosen on the host (ops/ivf_scan.py::scan_schedule) by the
// mean group size: the CUDA cores for small groups, every dtype and any
// view; wgmma for large groups of bf16 lists (further below).
//
// The CUDA-core design. A block takes one tile of one list (256 rows, as
// the wrapper sets it); the grid is (list, tile), or (pair, tile) while
// B * nprobe < nlist, sized on the host with no sync. The block first
// gathers the (query b, probe rank p) pairs that probe its list: it scans
// the (B, nprobe) probe array itself while B * nprobe <= PROLOGUE_MAX (one
// launch), else it reads them from the CSR that ivf_scan_plan_kernel built
// by counting sort (a second, one-block launch). A block whose list nobody
// probes, or whose pair is not its list's first, exits at once. The
// tile's mask and norms go to shared memory in one read; rows past its
// last live row are only written -inf. Where the tile's rows are
// contiguous and 16-byte aligned (the index's own lists), one thread
// streams them through a ring of two to four stages of 16 rows (1D bulk
// copies, cp.async.bulk, completing on an mbarrier a stage), started
// before the queries load; otherwise the warps read rows straight from
// global memory (16-byte loads, or element loads for rows off 16 bytes).
// In passes of up to 8 pairs the block holds the pairs' queries in shared
// memory (f32); each warp takes two rows at a time, dots both against
// every query of the pass, reduces with shuffles, and lanes 0-7 / 8-15
// write the two rows' masked scores, one pair each. A pass beyond the
// first streams the tile again.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = THREADS;       // rows of one list a block covers at most (a thread each)
constexpr int QG = 8;               // pairs a pass holds at most (lanes 0-15 write)
constexpr int PROLOGUE_MAX = 1024;  // B * nprobe a block scans itself
constexpr int MAX_SLOTS = 4;        // ring stages
constexpr long RING_BYTES = 72 * 1024;  // the ring's shared memory at most
constexpr int MAX_DYN_SMEM = 160 * 1024;  // the ring and a pass's queries at most
constexpr int PLAN_THREADS = 1024;

enum Dtype { F32 = 0, BF16 = 1, I8 = 2 };
enum Mode { IP = 0, L2 = 1, RESID = 2 };

template <int DT>
struct Elem;
template <>
struct Elem<F32> {
  static constexpr int SIZE = 4;
  static constexpr int W = 4;  // elements in 16 bytes
  __device__ static float load(const char* row, int i) {
    return reinterpret_cast<const float*>(row)[i];
  }
  __device__ static void widen(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
};
template <>
struct Elem<BF16> {
  static constexpr int SIZE = 2;
  static constexpr int W = 8;
  __device__ static float load(const char* row, int i) {
    return __uint_as_float((unsigned)reinterpret_cast<const unsigned short*>(row)[i] << 16);
  }
  __device__ static void widen(const uint4& v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);             // low bf16
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);  // high bf16
    }
  }
};
template <>
struct Elem<I8> {
  static constexpr int SIZE = 1;
  static constexpr int W = 16;
  __device__ static float load(const char* row, int i) {
    return (float)reinterpret_cast<const signed char*>(row)[i];
  }
  __device__ static void widen(const uint4& v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[4 * i + b] = (float)(signed char)((w[i] >> (8 * b)) & 0xffu);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The inversion of probe for B * nprobe > PROLOGUE_MAX: a counting sort of
// the pair ids i = b * nprobe + p by list. One block: counts (global
// atomics), an exclusive scan into offsets[0, nlist], then a scatter.
// The order of pairs within a list is arbitrary (no score depends on it).
// Ids outside [0, nlist) are skipped.
__global__ void __launch_bounds__(PLAN_THREADS)
ivf_scan_plan_kernel(const int64_t* __restrict__ probe, int n, int nlist,
                     int* __restrict__ offsets, int* __restrict__ cursor,
                     int* __restrict__ pairs) {
  __shared__ int warp_tot[PLAN_THREADS / 32];
  __shared__ int carry;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  for (int c = tid; c < nlist; c += PLAN_THREADS) cursor[c] = 0;
  if (tid == 0) carry = 0;
  __syncthreads();
  for (int i = tid; i < n; i += PLAN_THREADS) {
    const int64_t c = probe[i];
    if (c >= 0 && c < nlist) atomicAdd(&cursor[c], 1);
  }
  __syncthreads();
  for (int base = 0; base < nlist; base += PLAN_THREADS) {
    const int c = base + tid;
    const int v = c < nlist ? cursor[c] : 0;
    int incl = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int w = warp_tot[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(0xffffffffu, w, o);
        if (lane >= o) w += t;
      }
      warp_tot[lane] = w;  // inclusive over warps
    }
    __syncthreads();
    const int before = carry + (warp > 0 ? warp_tot[warp - 1] : 0);
    if (c < nlist) offsets[c] = before + incl - v;
    __syncthreads();
    if (tid == 0) carry += warp_tot[PLAN_THREADS / 32 - 1];
    __syncthreads();
  }
  if (tid == 0) offsets[nlist] = carry;
  for (int c = tid; c < nlist; c += PLAN_THREADS) cursor[c] = offsets[c];
  __syncthreads();
  for (int i = tid; i < n; i += PLAN_THREADS) {
    const int64_t c = probe[i];
    if (c >= 0 && c < nlist) pairs[atomicAdd(&cursor[c], 1)] = i;
  }
}

template <int MODE>
__device__ __forceinline__ float finish(float dot, float add, float sq) {
  if (MODE == L2) {
    // -((|q|^2 - 2 dot) + |x|^2), rounded at each step as the plain version
    return -__fadd_rn(__fsub_rn(add, __fmul_rn(2.0f, dot)), sq);
  } else if (MODE == RESID) {
    return __fadd_rn(add, __fmul_rn(dot, sq));
  }
  return dot;
}

// acc0[g] / acc1[g] += row0 / row1 . q_s[g] for the pass's ng queries,
// this lane's share (16-byte chunks lane, lane + 32, ..., then the tail
// element by element). FROM: GLOBAL_VEC (__ldg of 16 bytes), SHARED (rows
// staged by the ring), SCALAR (element loads only: rows off 16 bytes).
enum From { SCALAR = 0, GLOBAL_VEC = 1, SHARED = 2 };

template <int DT, int FROM>
__device__ __forceinline__ void accumulate(const char* row0, const char* row1, bool ok0,
                                           bool ok1, int d, const float* q_s, int dq, int ng,
                                           float (&acc0)[QG], float (&acc1)[QG]) {
  using E = Elem<DT>;
  const int lane = threadIdx.x % 32;
  const int n_vec = FROM == SCALAR ? 0 : d / E::W;
  if (FROM != SCALAR) {
    const uint4* rv0 = reinterpret_cast<const uint4*>(row0);
    const uint4* rv1 = reinterpret_cast<const uint4*>(row1);
#pragma unroll 2
    for (int v = lane; v < n_vec; v += 32) {
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      uint4 a = zero, bb = zero;
      if (FROM == SHARED) {
        if (ok0) a = rv0[v];
        if (ok1) bb = rv1[v];
      } else {
        if (ok0) a = __ldg(rv0 + v);
        if (ok1) bb = __ldg(rv1 + v);
      }
      float fa[E::W], fb[E::W];
      E::widen(a, fa);
      E::widen(bb, fb);
#pragma unroll
      for (int g = 0; g < QG; ++g) {
        if (g < ng) {
          const float* qv = q_s + g * dq + v * E::W;
#pragma unroll
          for (int e = 0; e < E::W; e += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qv + e);
            acc0[g] = fmaf(fa[e], q4.x, acc0[g]);
            acc0[g] = fmaf(fa[e + 1], q4.y, acc0[g]);
            acc0[g] = fmaf(fa[e + 2], q4.z, acc0[g]);
            acc0[g] = fmaf(fa[e + 3], q4.w, acc0[g]);
            acc1[g] = fmaf(fb[e], q4.x, acc1[g]);
            acc1[g] = fmaf(fb[e + 1], q4.y, acc1[g]);
            acc1[g] = fmaf(fb[e + 2], q4.z, acc1[g]);
            acc1[g] = fmaf(fb[e + 3], q4.w, acc1[g]);
          }
        }
      }
    }
  }
  for (int i = n_vec * E::W + lane; i < d; i += 32) {
    const float a = ok0 ? E::load(row0, i) : 0.0f;
    const float bb = ok1 ? E::load(row1, i) : 0.0f;
#pragma unroll
    for (int g = 0; g < QG; ++g) {
      if (g < ng) {
        const float qv = q_s[g * dq + i];
        acc0[g] = fmaf(a, qv, acc0[g]);
        acc1[g] = fmaf(bb, qv, acc1[g]);
      }
    }
  }
}

// The block's state shared by its warps: the pairs of the current pass,
// and the tile's mask and norms.
struct Tile {
  long off[QG];  // out offset of pair g's slot r_begin: b * out_stride + p * lmax + r_begin
  float add[QG];  // q_sq[b] (l2), cross[b, c] (int8 residual codes)
  int b[QG];
  float sq[ROWS];
  uint8_t ok[ROWS];
};

// Scores rows r (and r + 1 when has1) of the tile for the pass's pairs and
// writes them: lane g row r for pair g, lane QG + g row r + 1. Dead rows
// are not read and score -inf.
template <int DT, int MODE, int FROM>
__device__ __forceinline__ void score_pair(const char* row0, const char* row1, int r, bool has1,
                                           int d, const float* q_s, int dq, int ng,
                                           const Tile& t, float* __restrict__ out) {
  const int lane = threadIdx.x % 32;
  const bool ok0 = t.ok[r] != 0;
  const bool ok1 = has1 && t.ok[r + 1] != 0;
  float acc0[QG], acc1[QG];
#pragma unroll
  for (int g = 0; g < QG; ++g) acc0[g] = acc1[g] = 0.0f;
  if (ok0 || ok1) {  // warp-uniform: a dead row is never read
    accumulate<DT, FROM>(row0, row1, ok0, ok1, d, q_s, dq, ng, acc0, acc1);
#pragma unroll
    for (int g = 0; g < QG; ++g) {
      if (g < ng) {
        acc0[g] = warp_sum(acc0[g]);
        acc1[g] = warp_sum(acc1[g]);
      }
    }
  }
  const int g = lane % QG;
  const bool second = lane / QG == 1;
  float dot = 0.0f;
#pragma unroll
  for (int j = 0; j < QG; ++j)
    if (g == j) dot = second ? acc1[j] : acc0[j];
  if (lane < 2 * QG && g < ng && (!second || has1)) {
    const int rr = r + (second ? 1 : 0);
    const bool ok = second ? ok1 : ok0;
    out[t.off[g] + rr] = ok ? finish<MODE>(dot, t.add[g], t.sq[rr]) : -INFINITY;
  }
}

template <int DT, int MODE, int FROM>
__global__ void __launch_bounds__(THREADS, 2)
ivf_scan_kernel(const float* __restrict__ qc, const int64_t* __restrict__ probe,
                const int* __restrict__ offsets, const int* __restrict__ pairs,
                const char* __restrict__ lists, long list_stride, long row_stride,
                const float* __restrict__ sqnorm, const uint8_t* __restrict__ valid,
                const float* __restrict__ cross, const float* __restrict__ q_sq,
                float* __restrict__ out, long out_stride, int n_pairs_all, int nprobe,
                int lmax, int d, int dq, int qg, int nlist, int tiles, int tile_rows,
                int by_pair, int stage_rows, int slots) {
  // dynamic: the ring (FROM == SHARED: slots stages of stage_rows rows),
  // then qg queries dq floats apart
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_pairs[PROLOGUE_MAX];
  __shared__ Tile t;
  __shared__ __align__(8) uint64_t full[MAX_SLOTS];
  __shared__ int s_n, s_lead, s_live;
  using E = Elem<DT>;
  const int item = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int tid = threadIdx.x, warp = tid / 32;
  const int c = by_pair ? (int)probe[item] : item;

  // the pairs that probe list c; with one block per pair, the list's
  // first pair (least id in the prologue, first in the CSR) takes it
  int n;
  const int* group;
  if (offsets == nullptr) {
    if (tid == 0) {
      s_n = 0;
      s_lead = 0x7fffffff;
    }
    __syncthreads();
    const int lane = tid % 32;
    for (int base = 0; base < n_pairs_all; base += THREADS) {
      const int i = base + tid;
      const bool take = i < n_pairs_all && probe[i] == c;
      const unsigned mask = __ballot_sync(0xffffffffu, take);
      if (mask == 0) continue;
      const int leader = __ffs(mask) - 1;
      int at = 0;
      if (lane == leader) {
        at = atomicAdd(&s_n, __popc(mask));
        atomicMin(&s_lead, base + warp * 32 + leader);
      }
      at = __shfl_sync(0xffffffffu, at, leader);
      if (take) s_pairs[at + __popc(mask & ((1u << lane) - 1u))] = i;
    }
    __syncthreads();
    n = s_n;
    group = s_pairs;
    if (by_pair && s_lead != item) return;
  } else {
    n = offsets[c + 1] - offsets[c];
    group = pairs + offsets[c];
    if (by_pair && (n == 0 || group[0] != item)) return;
  }
  if (n == 0) return;  // nobody probes this list

  // the tile's mask and norms, and its last live row
  const int r_begin = tile * tile_rows;
  const int rows = min(tile_rows, lmax - r_begin);
  const long cell0 = (long)c * lmax + r_begin;
  if (tid == 0) s_live = 0;
  __syncthreads();
  if (tid < rows) {
    const uint8_t ok = valid[cell0 + tid];
    t.ok[tid] = ok;
    t.sq[tid] = sqnorm[cell0 + tid];
    if (ok) atomicMax(&s_live, tid + 1);
  }
  __syncthreads();
  const int live = s_live;  // rows [live, rows) are dead
  if (live == 0) {  // padding or deleted rows only: -inf for every pair
    for (int idx = tid; idx < n * rows; idx += THREADS) {
      const int g = idx / rows, r = idx % rows;
      const int pid = group[g];
      out[(long)(pid / nprobe) * out_stride + (long)(pid % nprobe) * lmax + r_begin + r] =
          -INFINITY;
    }
    return;
  }

  const long row_bytes = (long)d * E::SIZE;
  const int passes = (n + qg - 1) / qg;
  const int n_st = (live + stage_rows - 1) / stage_rows;  // ring stages a pass
  const int total = passes * n_st;
  const long stage_bytes = (long)stage_rows * row_bytes;
  unsigned char* ring = smem;
  float* q_s = reinterpret_cast<float*>(smem + (FROM == SHARED ? slots * stage_bytes : 0));
  const char* tile_base = lists + ((long)c * list_stride + (long)r_begin * row_stride) * E::SIZE;
  auto load_stage = [&](int js) {  // stage js % n_st of the tile into slot js % slots
    const int st = js % n_st;
    const int here = min(stage_rows, live - st * stage_rows);
    const uint32_t bytes = (uint32_t)(here * row_bytes);
    uint64_t* bar = &full[js % slots];
    hopper::mbar_arrive_expect_tx(bar, bytes);
    hopper::bulk_load(ring + (js % slots) * stage_bytes, tile_base + st * stage_bytes, bytes,
                      bar);
  };
  if (FROM == SHARED && tid == 0) {  // the stream starts before the queries load
    for (int s = 0; s < slots; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_barrier_init();
    for (int js = 0; js < min(slots, total); ++js) load_stage(js);
  }

  for (int pass = 0; pass < passes; ++pass) {
    const int q0 = pass * qg;
    const int ng = min(qg, n - q0);
    __syncthreads();  // the previous pass is done with q_s and t's pairs
    if (tid < ng) {
      const int pid = group[q0 + tid];
      const int b = pid / nprobe, p = pid % nprobe;
      t.b[tid] = b;
      t.off[tid] = (long)b * out_stride + (long)p * lmax + r_begin;
      t.add[tid] = MODE == L2 ? q_sq[b] : (MODE == RESID ? cross[(long)b * nlist + c] : 0.0f);
    }
    __syncthreads();
    for (int g = 0; g < ng; ++g) {
      const float* src = qc + (long)t.b[g] * d;
      for (int i = tid; i < d; i += THREADS) q_s[g * dq + i] = src[i];
    }
    __syncthreads();

    if (FROM == SHARED) {
      for (int st = 0; st < n_st; ++st) {
        const int js = pass * n_st + st;
        hopper::mbar_wait(&full[js % slots], (uint32_t)(js / slots) & 1u);
        const unsigned char* stage = ring + (js % slots) * stage_bytes;
        const int r0 = st * stage_rows;
        const int here = min(stage_rows, live - r0);
        for (int pr = 2 * warp; pr < here; pr += 2 * WARPS) {
          const char* row0 = reinterpret_cast<const char*>(stage) + pr * row_bytes;
          score_pair<DT, MODE, SHARED>(row0, row0 + row_bytes, r0 + pr, pr + 1 < here, d, q_s,
                                       dq, ng, t, out);
        }
        __syncthreads();  // the slot is read
        if (tid == 0 && js + slots < total) load_stage(js + slots);
      }
    } else {
      for (int pr = 2 * warp; pr < live; pr += 2 * WARPS) {
        const char* row0 = tile_base + (long)pr * row_stride * E::SIZE;
        score_pair<DT, MODE, FROM>(row0, row0 + row_stride * E::SIZE, pr, pr + 1 < live, d,
                                   q_s, dq, ng, t, out);
      }
    }
    // rows past the last live one: -inf for the pass's pairs
    for (int idx = tid; idx < ng * (rows - live); idx += THREADS) {
      const int g = idx / (rows - live), r = live + idx % (rows - live);
      out[t.off[g] + r] = -INFINITY;
    }
  }
}

struct Args {
  const float* qc;
  const int64_t* probe;
  const int* offsets;
  const int* pairs;
  const char* lists;
  long list_stride, row_stride;
  const float* sqnorm;
  const uint8_t* valid;
  const float* cross;
  const float* q_sq;
  float* out;
  long out_stride;
  int n_pairs_all, nprobe, lmax, d, dq, qg, nlist, tiles, tile_rows, by_pair, stage_rows,
      slots;
};

template <int DT, int MODE, int FROM>
cudaError_t launch_one(dim3 grid, size_t smem, cudaStream_t s, const Args& a) {
  auto kernel = ivf_scan_kernel<DT, MODE, FROM>;
  static bool smem_set[64] = {};
  if (smem > (size_t)MAX_DYN_SMEM) return cudaErrorInvalidValue;
  const cudaError_t err = hopper::max_dynamic_smem_once(kernel, MAX_DYN_SMEM, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, s>>>(a.qc, a.probe, a.offsets, a.pairs, a.lists,
                                     a.list_stride, a.row_stride, a.sqnorm, a.valid, a.cross,
                                     a.q_sq, a.out, a.out_stride, a.n_pairs_all, a.nprobe,
                                     a.lmax, a.d, a.dq, a.qg, a.nlist, a.tiles, a.tile_rows,
                                     a.by_pair, a.stage_rows, a.slots);
  return cudaGetLastError();
}

template <int DT, int MODE>
cudaError_t launch_mode(int from, dim3 grid, size_t smem, cudaStream_t s, const Args& a) {
  switch (from) {
    case SHARED:
      return launch_one<DT, MODE, SHARED>(grid, smem, s, a);
    case GLOBAL_VEC:
      return launch_one<DT, MODE, GLOBAL_VEC>(grid, smem, s, a);
    default:
      return launch_one<DT, MODE, SCALAR>(grid, smem, s, a);
  }
}

// f32 and bf16 lists score ip or l2, int8 codes only the residual mode
// (the instantiations the wrapper can ask for, and no others to compile)
template <int DT>
cudaError_t launch_dtype(int mode, int from, dim3 grid, size_t smem, cudaStream_t s,
                         const Args& a) {
  if (mode == IP) return launch_mode<DT, IP>(from, grid, smem, s, a);
  if (mode == L2) return launch_mode<DT, L2>(from, grid, smem, s, a);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------- wgmma (large groups) --
//
// Where a list's group is large (B * nprobe well past nlist), the scan is
// a small GEMM a tile: 128 list rows (A, two consumer warpgroups of 64)
// times a pass of TC_QB group queries (B). The wrapper gathers the
// groups' queries, in CSR order and rounded to bf16 (exact: qc already is
// bf16), into a (B * nprobe, d) buffer, so a pass's queries are TC_QB
// consecutive rows of it. Both operands arrive by TMA in 64-wide d slices
// (128-byte swizzle) through a ring of TC_STAGES stages with a full/empty
// mbarrier pair each; one producer thread keeps it full. Each consumer
// warpgroup accumulates m64nQBk16 products in f32 registers; the epilogue
// writes every (row, pair) score where the CUDA-core path would.

constexpr int TC_ROWS = 128;
constexpr int TC_KT = 64;
constexpr int TC_STAGES = 4;
constexpr int TC_CONSUMERS = 256;
constexpr int TC_THREADS = TC_CONSUMERS + 128;  // + a producer warpgroup (one thread loads)

template <int QB>
struct TcLayout {
  static constexpr int A_BYTES = TC_ROWS * TC_KT * 2;
  static constexpr int B_BYTES = QB * TC_KT * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;  // a multiple of 1024
  static constexpr int SMEM = 1024 + TC_STAGES * STAGE;  // + alignment slack
};

template <int QB>
__device__ __forceinline__ void tc_mma(float (&acc)[QB / 2], uint64_t a, uint64_t b,
                                       int scale_d);
template <>
__device__ __forceinline__ void tc_mma<64>(float (&acc)[32], uint64_t a, uint64_t b,
                                           int scale_d) {
  hopper::wgmma_m64n64k16_ss(acc, a, b, scale_d);
}
template <>
__device__ __forceinline__ void tc_mma<128>(float (&acc)[64], uint64_t a, uint64_t b,
                                            int scale_d) {
  hopper::wgmma_m64n128k16_ss(acc, a, b, scale_d);
}

template <int MODE, int QB>
__global__ void __launch_bounds__(TC_THREADS, 1)
ivf_scan_tc_kernel(const __grid_constant__ CUtensorMap amap,
                   const __grid_constant__ CUtensorMap qmap, const int* __restrict__ offsets,
                   const int* __restrict__ pairs, const float* __restrict__ sqnorm,
                   const uint8_t* __restrict__ valid, const float* __restrict__ cross,
                   const float* __restrict__ q_sq, float* __restrict__ out, long out_stride,
                   int nprobe, int lmax, int d, int nlist, int tiles) {
  using Lay = TcLayout<QB>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  __shared__ __align__(8) uint64_t full[TC_STAGES], empty[TC_STAGES];
  __shared__ long s_off[QB];
  __shared__ float s_add[QB];
  __shared__ float s_sq[TC_ROWS];
  __shared__ uint8_t s_ok[TC_ROWS];
  __shared__ int s_live;
  const int c = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int tid = threadIdx.x;
  const int first = offsets[c];
  const int n = offsets[c + 1] - first;
  if (n == 0) return;  // nobody probes this list
  const int r_begin = tile * TC_ROWS;
  const int rows = min(TC_ROWS, lmax - r_begin);
  const long cell0 = (long)c * lmax + r_begin;
  if (tid == 0) s_live = 0;
  __syncthreads();
  if (tid < rows) {
    const uint8_t ok = valid[cell0 + tid];
    s_ok[tid] = ok;
    s_sq[tid] = sqnorm[cell0 + tid];
    if (ok) atomicMax(&s_live, tid + 1);
  }
  __syncthreads();
  if (s_live == 0) {  // padding or deleted rows only: -inf for every pair
    for (int idx = tid; idx < n * rows; idx += TC_THREADS) {
      const int pid = pairs[first + idx / rows];
      out[(long)(pid / nprobe) * out_stride + (long)(pid % nprobe) * lmax + r_begin +
          idx % rows] = -INFINITY;
    }
    return;
  }
  if (tid == 0) {
    for (int s = 0; s < TC_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], TC_CONSUMERS / 32);  // lane 0 of each consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  const int passes = (n + QB - 1) / QB;
  const int n_k = (d + TC_KT - 1) / TC_KT;

  if (tid >= TC_CONSUMERS) {  // producer warpgroup: one thread keeps the ring full
    if (tid == TC_CONSUMERS) {
      hopper::prefetch_map(&amap);
      hopper::prefetch_map(&qmap);
      int stage = 0;
      uint32_t phase = 0;
      for (int pass = 0; pass < passes; ++pass) {
        for (int ks = 0; ks < n_k; ++ks) {
          hopper::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * Lay::STAGE;
          hopper::mbar_arrive_expect_tx(&full[stage], Lay::STAGE);
          hopper::tma_load_3d(st, &amap, &full[stage], ks * TC_KT, r_begin, c);
          hopper::tma_load_2d(st + Lay::A_BYTES, &qmap, &full[stage], ks * TC_KT,
                              first + pass * QB);
          if (++stage == TC_STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  int stage = 0;
  uint32_t phase = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int ng = min(QB, n - pass * QB);
    hopper::named_barrier_sync(1, TC_CONSUMERS);  // the last pass's epilogue is done
    if (tid < ng) {
      const int pid = pairs[first + pass * QB + tid];
      const int b = pid / nprobe, p = pid % nprobe;
      s_off[tid] = (long)b * out_stride + (long)p * lmax + r_begin;
      s_add[tid] = MODE == L2 ? q_sq[b] : (MODE == RESID ? cross[(long)b * nlist + c] : 0.0f);
    }
    float acc[QB / 2];
#pragma unroll
    for (int i = 0; i < QB / 2; ++i) acc[i] = 0.0f;
    for (int ks = 0; ks < n_k; ++ks) {
      hopper::mbar_wait(&full[stage], phase);
      const uint32_t aa = hopper::smem_u32(smem + stage * Lay::STAGE) + wg * 64 * 128;
      const uint32_t qa = hopper::smem_u32(smem + stage * Lay::STAGE + Lay::A_BYTES);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_KT / 16; ++kk) {
        tc_mma<QB>(acc, hopper::desc_sw128(aa + kk * 32, 16, 1024),
                   hopper::desc_sw128(qa + kk * 32, 16, 1024), (ks | kk) != 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (lane == 0) hopper::mbar_arrive(&empty[stage]);
      if (++stage == TC_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    hopper::named_barrier_sync(1, TC_CONSUMERS);  // s_off / s_add of this pass are written
    // acc[4j + i]: row 16 warp + lane / 4 + 8 (i / 2), column 8j + 2 (lane % 4) + i % 2
    const int r_lo = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < QB / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = 8 * j + 2 * (lane % 4) + (i % 2);
        const int r = r_lo + 8 * (i / 2);
        if (col < ng && r < rows) {
          out[s_off[col] + r] =
              s_ok[r] ? finish<MODE>(acc[4 * j + i], s_add[col], s_sq[r]) : -INFINITY;
        }
      }
    }
  }
}

template <int MODE, int QB>
cudaError_t launch_tc(const CUtensorMap& amap, const CUtensorMap& qmap, const int* offsets,
                      const int* pairs, const float* sqnorm, const uint8_t* valid,
                      const float* cross, const float* q_sq, float* out, long out_stride,
                      int nprobe, int lmax, int d, int nlist, cudaStream_t s) {
  auto kernel = ivf_scan_tc_kernel<MODE, QB>;
  const int smem = TcLayout<QB>::SMEM;
  static bool smem_set[64] = {};
  const cudaError_t err = hopper::max_dynamic_smem_once(kernel, smem, smem_set);
  if (err != cudaSuccess) return err;
  const int tiles = (lmax + TC_ROWS - 1) / TC_ROWS;
  kernel<<<(unsigned)(tiles * nlist), TC_THREADS, smem, s>>>(
      amap, qmap, offsets, pairs, sqnorm, valid, cross, q_sq, out, out_stride, nprobe, lmax, d,
      nlist, tiles);
  return cudaGetLastError();
}

template <int QB>
cudaError_t launch_tc_mode(int mode, const CUtensorMap& amap, const CUtensorMap& qmap,
                           const int* offsets, const int* pairs, const float* sqnorm,
                           const uint8_t* valid, const float* cross, const float* q_sq,
                           float* out, long out_stride, int nprobe, int lmax, int d, int nlist,
                           cudaStream_t s) {
  switch (mode) {
    case IP:
      return launch_tc<IP, QB>(amap, qmap, offsets, pairs, sqnorm, valid, cross, q_sq, out,
                               out_stride, nprobe, lmax, d, nlist, s);
    case L2:
      return launch_tc<L2, QB>(amap, qmap, offsets, pairs, sqnorm, valid, cross, q_sq, out,
                               out_stride, nprobe, lmax, d, nlist, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The largest B * nprobe a block inverts by scanning the probe array
// itself (past it the wrapper builds the CSR), and the most pairs a pass
// holds: the constants the wrapper's scan_schedule mirrors.
extern "C" int ivf_scan_prologue_max() { return PROLOGUE_MAX; }
extern "C" int ivf_scan_pass_max() { return QG; }

// The CSR of pair ids by list: probe (n,) int64 (n = B * nprobe, row-major
// (B, nprobe)); offsets (nlist + 1,), cursor (nlist,) and pairs (n,) int32
// scratch. One launch of one block on `stream`; returns its CUDA error.
extern "C" int ivf_scan_plan_launch(const void* probe, int n, int nlist, void* offsets,
                                    void* cursor, void* pairs, void* stream) {
  if (n <= 0 || nlist <= 0) return (int)cudaErrorInvalidValue;
  ivf_scan_plan_kernel<<<1, PLAN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(probe), n, nlist, static_cast<int*>(offsets),
      static_cast<int*>(cursor), static_cast<int*>(pairs));
  return (int)cudaGetLastError();
}

// C entry, bound with ctypes. dtype: 0 = float32, 1 = bfloat16, 2 = int8;
// mode: 0 = ip, 1 = l2 (f32, bf16), 2 = int8 residual (int8). lists is (nlist, Lmax, d) with
// element strides list_stride and row_stride and a dense last axis; vec = 1
// when its base and both strides are 16-byte aligned. sqnorm and valid are
// dense (nlist, Lmax); cross is (B, nlist) (mode 2), q_sq is (B,) (mode 1);
// out rows are out_stride floats apart. qg: the pairs a pass holds,
// 1 <= qg <= QG, in qg * round_up(d, 4) floats of shared memory (the
// wrapper's scan_schedule). by_pair: one grid row per (b, p) pair instead
// of one per list (while B * nprobe < nlist). tile_rows: the rows a block
// covers, 1 <= tile_rows <= ROWS. offsets / pairs: the CSR of
// ivf_scan_plan_launch, or null while B * nprobe <= PROLOGUE_MAX (each
// block then scans probe). With use_ring = 1 rows stream through the
// shared-memory ring where they are contiguous (row_stride == d) and
// 16-byte aligned; otherwise they load from global memory. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 on
// success).
extern "C" int ivf_scan_launch(const void* qc, const void* probe, const void* offsets,
                               const void* pairs, const void* lists, long list_stride,
                               long row_stride, const void* sqnorm, const void* valid,
                               const void* cross, const void* q_sq, void* out,
                               long out_stride, int B, int nprobe, int lmax, int d, int nlist,
                               int qg, int by_pair, int tile_rows, int use_ring, int dtype,
                               int mode, int vec, void* stream) {
  if (B <= 0 || nprobe <= 0 || lmax <= 0 || d <= 0 || nlist <= 0 || qg < 1 || qg > QG ||
      tile_rows < 1 || tile_rows > ROWS || dtype < F32 || dtype > I8) {
    return (int)cudaErrorInvalidValue;
  }
  const long n_pairs = (long)B * nprobe;
  if (n_pairs > 2147483647L || ((offsets == nullptr) != (pairs == nullptr)) ||
      (offsets == nullptr && n_pairs > PROLOGUE_MAX)) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = (lmax + tile_rows - 1) / tile_rows;
  const long items = by_pair ? n_pairs : nlist;
  if ((long)tiles * items > 2147483647L) return (int)cudaErrorInvalidValue;
  Args a;
  a.qc = static_cast<const float*>(qc);
  a.probe = static_cast<const int64_t*>(probe);
  a.offsets = static_cast<const int*>(offsets);
  a.pairs = static_cast<const int*>(pairs);
  a.lists = static_cast<const char*>(lists);
  a.list_stride = list_stride;
  a.row_stride = row_stride;
  a.sqnorm = static_cast<const float*>(sqnorm);
  a.valid = static_cast<const uint8_t*>(valid);
  a.cross = static_cast<const float*>(cross);
  a.q_sq = static_cast<const float*>(q_sq);
  a.out = static_cast<float*>(out);
  a.out_stride = out_stride;
  a.n_pairs_all = (int)n_pairs;
  a.nprobe = nprobe;
  a.lmax = lmax;
  a.d = d;
  a.dq = (d + 3) / 4 * 4;  // 16-byte rows of q_s
  a.qg = qg;
  a.nlist = nlist;
  a.tiles = tiles;
  a.tile_rows = tile_rows;
  a.by_pair = by_pair ? 1 : 0;
  // the ring: stages of 16 rows (8 where three such stages pass the
  // budget), two to MAX_SLOTS of them
  static const int elem[3] = {4, 2, 1};
  const long row_bytes = (long)d * elem[dtype];
  a.stage_rows = 3 * 16 * row_bytes <= RING_BYTES ? 16 : 8;
  const long fit = RING_BYTES / (a.stage_rows * row_bytes);
  a.slots = (int)(fit < MAX_SLOTS ? fit : MAX_SLOTS);
  int from = vec ? GLOBAL_VEC : SCALAR;
  if (vec && use_ring && row_stride == d && a.slots >= 2) from = SHARED;
  const size_t ring = from == SHARED ? (size_t)a.slots * a.stage_rows * row_bytes : 0;
  const size_t smem = ring + (size_t)a.qg * a.dq * sizeof(float);
  const dim3 grid((unsigned)(tiles * items));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case F32:
      return (int)launch_dtype<F32>(mode, from, grid, smem, s, a);
    case BF16:
      return (int)launch_dtype<BF16>(mode, from, grid, smem, s, a);
    default:
      return mode == RESID ? (int)launch_mode<I8, RESID>(from, grid, smem, s, a)
                           : (int)cudaErrorInvalidValue;
  }
}

// The wgmma path, bound with ctypes: bf16 lists (nlist, Lmax, d) with a
// dense last axis, 16-byte-aligned base and strides (list_stride,
// row_stride elements) and d % 8 == 0; qg the (n_pairs, d) bf16 queries of
// the CSR (offsets, pairs) in its order; mode 0 = ip, 1 = l2; qb 64 or 128
// queries a pass. The rest as ivf_scan_launch. One launch on `stream`.
extern "C" int ivf_scan_tc_launch(const void* qg, const void* offsets, const void* pairs,
                                  const void* lists, long list_stride, long row_stride,
                                  const void* sqnorm, const void* valid, const void* q_sq,
                                  void* out, long out_stride, int n_pairs, int nprobe,
                                  int lmax, int d, int nlist, int mode, int qb, void* stream) {
  if (n_pairs <= 0 || nprobe <= 0 || lmax <= 0 || d <= 0 || d % 8 != 0 || nlist <= 0 ||
      (qb != 64 && qb != 128) || (mode != IP && mode != L2) || offsets == nullptr ||
      pairs == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const long tiles = (lmax + TC_ROWS - 1) / TC_ROWS;
  if (tiles * nlist > 2147483647L) return (int)cudaErrorInvalidValue;
  CUtensorMap amap, qmap;
  const uint64_t adims[3] = {(uint64_t)d, (uint64_t)lmax, (uint64_t)nlist};
  const uint64_t astrides[2] = {(uint64_t)row_stride * 2, (uint64_t)list_stride * 2};
  const uint32_t abox[3] = {TC_KT, TC_ROWS, 1};
  const uint64_t qdims[2] = {(uint64_t)d, (uint64_t)n_pairs};
  const uint64_t qstrides[1] = {(uint64_t)d * 2};
  const uint32_t qbox[2] = {TC_KT, (uint32_t)qb};
  if (!hopper::make_map_bf16(&amap, lists, 3, adims, astrides, abox) ||
      !hopper::make_map_bf16(&qmap, qg, 2, qdims, qstrides, qbox)) {
    return (int)cudaErrorInvalidValue;
  }
  const int* o = static_cast<const int*>(offsets);
  const int* pr = static_cast<const int*>(pairs);
  const float* sq = static_cast<const float*>(sqnorm);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const float* qs = static_cast<const float*>(q_sq);
  float* ot = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (qb == 64) {
    return (int)launch_tc_mode<64>(mode, amap, qmap, o, pr, sq, v, nullptr, qs, ot, out_stride,
                                   nprobe, lmax, d, nlist, s);
  }
  return (int)launch_tc_mode<128>(mode, amap, qmap, o, pr, sq, v, nullptr, qs, ot, out_stride,
                                  nprobe, lmax, d, nlist, s);
}
