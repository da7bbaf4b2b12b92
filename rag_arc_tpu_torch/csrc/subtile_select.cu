// Sub-tile select of the two-level exact top-k, for Hopper (sm_90a).
//
// For each row b of a (B, C) f32 matrix x (the producers' sub-tile
// maxima), computes
//
//   picked[b, j] = the index of the (j+1)-th largest entry, j < k, in the
//                  order (value descending, index ascending);
//   live[b, j]   = that entry's value > NEG / 2;
//   resid[b]     = max(NEG, the (k+1)-th value in that order), or NEG
//                  when k == C: the max of the entries not picked.
//
// -0.0 and +0.0 are one value (they tie, the lower index first, as under
// torch.argmax). The producers write no NaN; the kernel assumes none.
//
// Replaces the XLA program rag_arc_tpu/ops/two_level.py::
// iterative_argmax_resid (no Pallas kernel there): a tournament of k
// steps, each a handful of small launches in the port's plain version.
// Where the plain version runs out of live entries it re-picks positions;
// here every pick is a distinct index, so dead picks may differ from it
// while live picks, flags and the residual are equal.
//
// What bounds it on an H100: one read of x, B*C*4 bytes (256 MB at the
// main shape B = 512, C = 125,000), against HBM: ~0.076 ms.
//
// Design. Every entry becomes a 64-bit composite key, an order-preserving
// uint32 of the value above the complement of its index, so that the
// composite order is exactly the pick order and no two entries tie. A
// block streams its row through a ring of five 8 KB stages in shared
// memory, two stages a step: one thread keeps the other three in flight
// with 1D bulk copies (cp.async.bulk, completing on an mbarrier a stage),
// so the stream goes on while the block filters, and the block meets one
// barrier a step. Each thread reads its 16 bytes of each stage and
// appends every entry at or above a threshold T to a buffer of 8192
// composites in shared memory (warp-aggregated: one shared atomic a warp
// an entry slot); the few entries before the row's first 16-byte boundary
// and after its last take scalar loads. When the buffer has no room for
// the next step, a radix select over the buffer (8-bit digits from the top,
// warp-aggregated histograms) raises T to the lower bound of a digit bin
// that keeps at least k + 1 entries and at most max(k + 1, 256), and the
// buffer is compacted to those. Entries below T cannot be among the k + 1
// largest, so after the row the buffer holds them all: one last radix
// select cuts it to exactly k + 1, and a bitonic sort in shared memory
// orders them. Picks are the first k, the residual the (k+1)-th. No copy
// of x is made. 104 KB of shared memory a block: two blocks an SM, 48 KB
// of the row in flight while both filter.
//
// k + 1 > FAST_K1 does not fit that buffer: each row's composites are then
// written to a global scratch (B, P) (P = C rounded up to a power of two,
// allocated by the caller) and bitonic-sorted there by its block. Slow,
// and correct for every k <= C; the index paths ask for k of at most a
// few hundred.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG = -3.0e38f;         // sentinel below any real score
constexpr int THREADS = 512;
constexpr int STAGE = THREADS * 4;      // 2048 entries (8 KB) a ring stage: 16 bytes a thread
constexpr int STAGES = 5;               // ring depth: three stages in flight while two are read
constexpr int CAP = 8192;               // composites the shared buffer holds (64 KB)
constexpr int FAST_K1 = CAP - 2 * STAGE;  // k + 1 up to this takes the shared buffer
constexpr int STREAM_KEEP = 256;        // entries a shrink keeps while streaming (at least k + 1)
constexpr int RING_BYTES = STAGES * STAGE * 4;
constexpr int SMEM = RING_BYTES + CAP * 8;

// Order-preserving uint32 of a float, -0.0 keyed as +0.0.
__device__ __forceinline__ uint32_t order_key(float v) {
  uint32_t b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// Value key above the index's complement: larger composite = earlier pick.
__device__ __forceinline__ uint64_t composite(float v, int i) {
  return ((uint64_t)order_key(v) << 32) | (uint64_t)(~(uint32_t)i);
}

__device__ __forceinline__ int pick_index(uint64_t c) { return (int)(~(uint32_t)c); }

__device__ __forceinline__ float pick_value(uint64_t c) { return key_value((uint32_t)(c >> 32)); }

// Appends c to buf for every lane that takes one: one shared atomic per
// warp. Every lane of the warp must call it.
__device__ __forceinline__ void append(uint64_t* buf, int* cnt, bool take, uint64_t c) {
  const unsigned mask = __ballot_sync(0xffffffffu, take);
  if (mask == 0) return;
  const int lane = threadIdx.x % 32;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(cnt, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (take) buf[base + __popc(mask & ((1u << lane) - 1u))] = c;
}

// The lower bound T of a digit bin such that at least `need` and at most
// max(need, target) of buf[0, n) are >= T (n >= need). Radix select over
// 8-bit digits from the top, stopping at the first digit whose bin keeps
// few enough; at the last digit exactly `need` remain (composites are
// distinct). Block-wide: every thread calls it and gets T.
__device__ uint64_t select_threshold(const uint64_t* buf, int n, int need, int target,
                                     uint32_t* hist, int* sel) {
  const int tid = threadIdx.x, lane = tid % 32;
  uint64_t prefix = 0;
  int kept_above = 0;
  for (int shift = 56;; shift -= 8) {
    for (int i = tid; i < 256; i += THREADS) hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < n; base += THREADS) {
      const int i = base + tid;
      bool in = false;
      uint32_t digit = 0;
      if (i < n) {
        const uint64_t c = buf[i];
        in = shift == 56 || (c >> (shift + 8)) == prefix;
        digit = (uint32_t)(c >> shift) & 0xffu;
      }
      // lanes that share a digit add once; the others get unique tags
      const unsigned same = __match_any_sync(0xffffffffu, in ? digit : 0x100u + lane);
      if (in && lane == __ffs(same) - 1) atomicAdd(&hist[digit], (uint32_t)__popc(same));
    }
    __syncthreads();
    if (tid < 32) {
      // lane l holds bins 255 - 8l down to 248 - 8l: counts from the top
      uint32_t part = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) part += hist[255 - 8 * lane - j];
      uint32_t incl = part;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      const unsigned hit = __ballot_sync(0xffffffffu, incl >= (uint32_t)need);
      if (lane == __ffs(hit) - 1) {
        uint32_t above = incl - part;
        int d = 255 - 8 * lane;
        for (int j = 0; j < 8; ++j, --d) {
          if (above + hist[d] >= (uint32_t)need) break;
          above += hist[d];
        }
        sel[0] = d;
        sel[1] = (int)above;
      }
    }
    __syncthreads();
    const int d = sel[0], gt = sel[1];
    const int kept = kept_above + gt + (int)hist[d];
    prefix = (prefix << 8) | (uint64_t)d;
    if (kept <= target || shift == 0) return prefix << shift;
    kept_above += gt;
    need -= gt;
    __syncthreads();  // hist and sel are rewritten by the next digit
  }
}

// Keeps the entries of buf[0, n) that are >= t, in any order.
__device__ void compact(uint64_t* buf, int* cnt, int n, uint64_t t) {
  uint64_t mine[CAP / THREADS];
#pragma unroll
  for (int j = 0; j < CAP / THREADS; ++j) {
    const int i = j * THREADS + threadIdx.x;
    mine[j] = i < n ? buf[i] : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) *cnt = 0;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < CAP / THREADS; ++j) {
    const int i = j * THREADS + threadIdx.x;
    append(buf, cnt, i < n && mine[j] >= t, mine[j]);
  }
  __syncthreads();
}

// Sorts a[0, p) descending (p a power of two), block-wide; `a` is shared
// or global memory of this block alone.
__device__ void bitonic_desc(uint64_t* a, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += THREADS) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const uint64_t u = a[lo], v = a[hi];
        if (desc ? u < v : u > v) {
          a[lo] = v;
          a[hi] = u;
        }
      }
      __syncthreads();
    }
  }
}

// Writes row b's picks, flags and residual from its sorted composites.
__device__ void write_row(const uint64_t* sorted, int b, int C, int k, int64_t* picked,
                          uint8_t* live, float* resid) {
  for (int j = threadIdx.x; j < k; j += THREADS) {
    const uint64_t c = sorted[j];
    picked[(size_t)b * k + j] = pick_index(c);
    live[(size_t)b * k + j] = pick_value(c) > NEG * 0.5f;
  }
  if (threadIdx.x == 0) resid[b] = C > k ? fmaxf(NEG, pick_value(sorted[k])) : NEG;
}

// Cuts buf[0, m) to at least min(m, k1) and at most max(k1, target) of
// its largest (exactly k1 at target = k1); returns the count kept.
__device__ int cut_to(uint64_t* buf, int* cnt, int m, int k1, int target, uint32_t* hist,
                      int* sel) {
  if (m <= target) return m;
  compact(buf, cnt, m, select_threshold(buf, m, k1, target, hist, sel));
  return *cnt;
}

__global__ void __launch_bounds__(THREADS, 2)
subtile_select_kernel(const float* __restrict__ x, int C, int k,
                      int64_t* __restrict__ picked, uint8_t* __restrict__ live,
                      float* __restrict__ resid, uint64_t* __restrict__ scratch, int scratch_p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);                 // STAGES x STAGE entries
  uint64_t* buf = reinterpret_cast<uint64_t*>(smem + RING_BYTES);  // CAP composites
  __shared__ __align__(8) uint64_t full[STAGES];
  __shared__ uint32_t hist[256];
  __shared__ int cnt;
  __shared__ int sel[2];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32;
  const float* row = x + (size_t)b * C;

  if (k + 1 > FAST_K1) {
    // large k: the whole row sorted in this row's global scratch
    uint64_t* s = scratch + (size_t)b * scratch_p;
    for (int i = tid; i < scratch_p; i += THREADS) s[i] = i < C ? composite(__ldg(row + i), i) : 0;
    __syncthreads();
    bitonic_desc(s, scratch_p);
    write_row(s, b, C, k, picked, live, resid);
    return;
  }

  // the row: `head` entries up to its first 16-byte boundary and the tail
  // past its last take scalar loads; the bulk between streams in stages
  int head = (int)((16u - (unsigned)(reinterpret_cast<uintptr_t>(row) & 15u)) & 15u) / 4;
  head = min(head, C);
  const int nbulk = (C - head) / 4 * 4;
  const int tail = C - head - nbulk;
  const int n_stages = (nbulk + STAGE - 1) / STAGE;
  const float* bulk = row + head;
  auto load_stage = [&](int j) {  // stage j of the row into ring slot j % STAGES
    const int first = j * STAGE;
    const uint32_t bytes = (uint32_t)min(STAGE, nbulk - first) * 4u;
    uint64_t* bar = &full[j % STAGES];
    hopper::mbar_arrive_expect_tx(bar, bytes);
    hopper::bulk_load(ring + (j % STAGES) * STAGE, bulk + first, bytes, bar);
  };

  if (tid == 0) {
    cnt = 0;
    for (int s = 0; s < STAGES; ++s) hopper::mbar_init(&full[s], 1);
    hopper::fence_barrier_init();
    for (int j = 0; j < min(STAGES, n_stages); ++j) load_stage(j);
  }
  __syncthreads();
  if (tid < 32) {  // head and tail into the empty buffer (T = 0)
    const bool take = lane < head + tail;
    const int i = lane < head ? lane : head + nbulk + (lane - head);
    append(buf, &cnt, take, take ? composite(__ldg(row + i), i) : 0);
  }
  __syncthreads();

  const int keep = k + 1 > STREAM_KEEP ? k + 1 : STREAM_KEEP;
  uint64_t t = 0;  // entries below t are not among the k + 1 largest
  // ub: a bound on cnt every thread holds alike (cnt itself may already
  // count another warp's appends of the current step)
  int ub = head + tail;
  // for k + 1 > 64 the first shrink comes after one step (a threshold
  // early, from 4096 entries rather than 8192): measured faster at k = 100,
  // slower at k = 10 and 20, where the later shrinks it brings cost more
  bool early = k + 1 > 64 && 2 * keep <= STAGE;
  for (int j = 0; j < n_stages; j += 2) {  // stages j and j + 1
    const bool two = j + 1 < n_stages;
    // the previous step's closing barrier: slots (j - 2) % STAGES and
    // (j - 1) % STAGES are read
    if (tid == 0 && j >= 2) {
      for (int s = j + STAGES - 2; s < min(j + STAGES, n_stages); ++s) load_stage(s);
    }
    if (ub + 2 * STAGE > CAP || (early && ub >= STAGE)) {
      // every append so far is done and none of this step's has begun
      early = false;
      const int n = cnt;
      const uint64_t raised = select_threshold(buf, n, k + 1, keep, hist, sel);
      if (raised > t) t = raised;
      compact(buf, &cnt, n, t);
      ub = cnt;
      __syncthreads();  // read before any append of this step
    }
    const int e0 = tid * 4;
    bool took = false;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int js = j + h;
      if (h == 1 && !two) break;  // block-uniform
      hopper::mbar_wait(&full[js % STAGES], (uint32_t)(js / STAGES) & 1u);
      const int first = js * STAGE;
      const bool in = e0 < nbulk - first;  // stages hold multiples of 4 entries
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (in) v = *reinterpret_cast<const float4*>(ring + (js % STAGES) * STAGE + e0);
      const float vals[4] = {v.x, v.y, v.z, v.w};
      const int i0 = head + first + e0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint64_t c = composite(vals[e], i0 + e);
        const bool take = in && c >= t;
        append(buf, &cnt, take, c);
        took |= take;
      }
    }
    // closes the step: its slots are read and its appends are done (a
    // thread appends at most 8)
    ub += 8 * __syncthreads_count(took);
  }
  // the row's last cut keeps up to twice k + 1 (fewer radix digits) where
  // the sort's buffer has room
  const int relaxed = 2 * (k + 1) <= CAP ? max(2 * (k + 1), 64) : k + 1;
  const int m = cut_to(buf, &cnt, cnt, k + 1, relaxed, hist, sel);
  // the buffer holds the k + 1 largest (all C entries when C <= k + 1),
  // and maybe a few more: sort them
  int p = 1;
  while (p < m) p <<= 1;
  for (int i = m + tid; i < p; i += THREADS) buf[i] = 0;  // 0 sorts below every composite
  __syncthreads();
  bitonic_desc(buf, p);
  write_row(buf, b, C, k, picked, live, resid);
}

}  // namespace

// The columns of the (B, cols) uint64 scratch a launch at (C, k) needs:
// 0 while k + 1 fits the shared buffer, else C rounded up to a power of
// two.
extern "C" int subtile_select_scratch_cols(int C, int k) {
  if (k + 1 <= FAST_K1) return 0;
  int p = 1;
  while (p < C) p <<= 1;
  return p;
}

// The constants the wrapper mirrors.
extern "C" int subtile_select_fast_k1() { return FAST_K1; }
extern "C" int subtile_select_stage() { return STAGE; }

// C entry, bound with ctypes. x: contiguous (B, C) f32 on the device;
// 1 <= k <= C. picked (B, k) int64, live (B, k) uint8, resid (B,) f32;
// scratch a (B, scratch_p) uint64 buffer, scratch_p =
// subtile_select_scratch_cols(C, k) (null when that is 0). Launches on
// `stream`, does not synchronise, and returns the CUDA error of the launch
// (0 on success).
extern "C" int subtile_select_launch(const void* x, int B, int C, int k, void* picked,
                                     void* live, void* resid, void* scratch, int scratch_p,
                                     void* stream) {
  if (B < 1 || C < 1 || k < 1 || k > C) return (int)cudaErrorInvalidValue;
  if (scratch_p != subtile_select_scratch_cols(C, k) || (scratch_p > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  static bool smem_set[64] = {};
  cudaError_t err = hopper::max_dynamic_smem_once(subtile_select_kernel, SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  subtile_select_kernel<<<B, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), C, k, static_cast<int64_t*>(picked),
      static_cast<uint8_t*>(live), static_cast<float*>(resid), static_cast<uint64_t*>(scratch),
      scratch_p);
  return (int)cudaGetLastError();
}
