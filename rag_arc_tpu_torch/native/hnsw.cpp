// HNSW approximate-nearest-neighbor index (from-scratch implementation of
// the Malkov & Yashunin algorithm; capability parity with the reference's
// FAISS IndexHNSWFlat, VectorStore_Faiss.py:120 M=32).
//
// Why C++ on host, in a TPU framework: HNSW search is irregular pointer
// chasing over a layered proximity graph — hostile to the TPU's vector
// units — so like the reference (which ran it inside FAISS's C++), it
// lives on the host CPU behind the same index interface as the HBM
// flat/IVF indexes. Single-writer / multi-reader: concurrent searches are
// safe; adds require external serialization (matches FAISS semantics).
//
// Build: g++ -O3 -march=native -shared -fPIC hnsw.cpp -o libhnsw.so
// Binding: ctypes (rag_arc_tpu/index/hnsw.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

enum Metric { METRIC_IP = 0, METRIC_L2 = 1 };

enum Quant { QUANT_F32 = 0, QUANT_SQ8 = 1, QUANT_PQ = 2 };

struct Hnsw {
  int dim;
  int M;        // max neighbors per node, levels > 0
  int maxM0;    // max neighbors at level 0 (2*M, per the paper)
  int efc;      // beam width during construction
  Metric metric;
  bool sq8;     // scalar int8 storage (per-vector symmetric scale): 4x
                // less resident memory than f32, FAISS IndexHNSWSQ-style
  bool pq;      // product quantization (FAISS IndexHNSWPQ-style): pq_m
                // bytes/vector + shared codebooks; query-node distances via
                // per-query ADC lookup tables (m adds instead of dim mults)
  int pq_m = 0;    // sub-spaces (dim % pq_m == 0); 256 centroids each
  int dsub = 0;    // dim / pq_m
  bool pq_trained = false;
  double level_mult;

  int64_t n = 0;
  std::vector<float> data;                    // n * dim        (f32 mode)
  std::vector<int8_t> codes;                  // n * dim        (sq8 mode)
  std::vector<float> scales;                  // n              (sq8 mode)
  std::vector<uint8_t> pqcodes;               // n * pq_m       (pq mode)
  std::vector<float> pq_centroids;            // pq_m * 256 * dsub
  std::vector<float> pq_sym;                  // pq_m * 256 * 256 symmetric
                                              // distance contributions
  std::vector<int> levels;                    // per node
  std::vector<std::vector<std::vector<int>>> links;  // node -> level -> ids
  std::vector<uint8_t> deleted;
  int entry = -1;
  int max_level = -1;
  std::mt19937_64 rng;

  Hnsw(int dim_, int m, int efc_, int metric_, uint64_t seed, int quant,
       int pq_m_ = 0)
      : dim(dim_), M(m), maxM0(2 * m), efc(efc_),
        metric(static_cast<Metric>(metric_)), sq8(quant == QUANT_SQ8),
        pq(quant == QUANT_PQ), pq_m(pq_m_),
        dsub(pq_m_ > 0 ? dim_ / pq_m_ : 0),
        level_mult(1.0 / std::log(std::max(2.0, double(m)))), rng(seed) {}

  inline const float* vec(int64_t id) const { return data.data() + id * dim; }
  inline const int8_t* code(int64_t id) const { return codes.data() + id * dim; }

  // distance: smaller is closer. ip/cosine -> negative dot product.
  inline float dist(const float* a, const float* b) const {
    float acc = 0.f;
    if (metric == METRIC_IP) {
      for (int i = 0; i < dim; ++i) acc += a[i] * b[i];
      return -acc;
    }
    for (int i = 0; i < dim; ++i) {
      const float d = a[i] - b[i];
      acc += d * d;
    }
    return acc;
  }

  // f32 query vs stored node
  inline float dist_qn(const float* q, int64_t id) const {
    if (!sq8) return dist(q, vec(id));
    const int8_t* c = code(id);
    const float s = scales[id];
    float acc = 0.f;
    if (metric == METRIC_IP) {
      for (int i = 0; i < dim; ++i) acc += q[i] * (float)c[i];
      return -acc * s;
    }
    for (int i = 0; i < dim; ++i) {
      const float d = q[i] - (float)c[i] * s;
      acc += d * d;
    }
    return acc;
  }

  // -- product quantization ------------------------------------------------

  inline const float* centroid(int j, int c) const {
    return pq_centroids.data() + ((int64_t)j * 256 + c) * dsub;
  }

  // ADC lookup table for one query: lut[j*256 + c] is sub-space j's
  // distance contribution if the node's j-th code is c. dist(q, node) is
  // then pq_m table adds — cheaper than a dim-length dot product.
  void build_lut(const float* q, float* lut) const {
    for (int j = 0; j < pq_m; ++j) {
      const float* qs = q + j * dsub;
      for (int c = 0; c < 256; ++c) {
        const float* cen = centroid(j, c);
        float acc = 0.f;
        if (metric == METRIC_IP) {
          for (int t = 0; t < dsub; ++t) acc -= qs[t] * cen[t];
        } else {
          for (int t = 0; t < dsub; ++t) {
            const float d = qs[t] - cen[t];
            acc += d * d;
          }
        }
        lut[(j << 8) + c] = acc;
      }
    }
  }

  inline float dist_lut(const float* lut, int64_t id) const {
    const uint8_t* cd = pqcodes.data() + id * pq_m;
    float acc = 0.f;
    for (int j = 0; j < pq_m; ++j) acc += lut[(j << 8) + cd[j]];
    return acc;
  }

  void encode_pq(const float* v, uint8_t* out) const {
    for (int j = 0; j < pq_m; ++j) {
      const float* vs = v + j * dsub;
      int best = 0;
      float best_d = 3.0e38f;
      for (int c = 0; c < 256; ++c) {
        const float* cen = centroid(j, c);
        float acc = 0.f;
        for (int t = 0; t < dsub; ++t) {
          const float d = vs[t] - cen[t];
          acc += d * d;
        }
        if (acc < best_d) {
          best_d = acc;
          best = c;
        }
      }
      out[j] = (uint8_t)best;
    }
  }

  // symmetric code-to-code tables (construction-time dist_nn): same
  // smaller-is-closer convention as dist()
  void build_sym_tables() {
    pq_sym.assign((size_t)pq_m * 256 * 256, 0.f);
    for (int j = 0; j < pq_m; ++j) {
      float* tab = pq_sym.data() + (size_t)j * 256 * 256;
      for (int a = 0; a < 256; ++a) {
        const float* ca = centroid(j, a);
        for (int b = a; b < 256; ++b) {
          const float* cb = centroid(j, b);
          float acc = 0.f;
          if (metric == METRIC_IP) {
            for (int t = 0; t < dsub; ++t) acc -= ca[t] * cb[t];
          } else {
            for (int t = 0; t < dsub; ++t) {
              const float d = ca[t] - cb[t];
              acc += d * d;
            }
          }
          tab[(a << 8) + b] = acc;
          tab[(b << 8) + a] = acc;
        }
      }
    }
  }

  // per-sub-space k-means (Lloyd, L2 — standard for PQ regardless of the
  // index metric); sub-spaces are independent, so they train in parallel
  void train_pq(const float* sample, int64_t count, int iters = 12) {
    pq_centroids.assign((size_t)pq_m * 256 * dsub, 0.f);
    const int64_t hw = (int64_t)std::thread::hardware_concurrency();
    const int64_t n_threads =
        std::max<int64_t>(1, std::min<int64_t>({hw, (int64_t)pq_m, 16}));
    std::atomic<int> next_j(0);
    auto train_one = [&](int j) {
      float* cents = pq_centroids.data() + (size_t)j * 256 * dsub;
      // init: spread over the sample (deterministic stride)
      for (int c = 0; c < 256; ++c) {
        const int64_t src = ((int64_t)c * count) / 256;
        std::memcpy(cents + c * dsub, sample + src * dim + j * dsub,
                    sizeof(float) * dsub);
      }
      std::vector<int> assign(count);
      std::vector<float> sums(256 * dsub);
      std::vector<int64_t> counts(256);
      for (int it = 0; it < iters; ++it) {
        std::fill(sums.begin(), sums.end(), 0.f);
        std::fill(counts.begin(), counts.end(), 0);
        for (int64_t i = 0; i < count; ++i) {
          const float* vs = sample + i * dim + j * dsub;
          int best = 0;
          float best_d = 3.0e38f;
          for (int c = 0; c < 256; ++c) {
            const float* cen = cents + c * dsub;
            float acc = 0.f;
            for (int t = 0; t < dsub; ++t) {
              const float d = vs[t] - cen[t];
              acc += d * d;
            }
            if (acc < best_d) {
              best_d = acc;
              best = c;
            }
          }
          assign[i] = best;
          counts[best]++;
          float* s = sums.data() + best * dsub;
          for (int t = 0; t < dsub; ++t) s[t] += vs[t];
        }
        for (int c = 0; c < 256; ++c) {
          if (counts[c] == 0) {
            // re-seed an empty cluster from a sample row (deterministic)
            const int64_t src = (int64_t)(c * 2654435761u) % count;
            std::memcpy(cents + c * dsub, sample + src * dim + j * dsub,
                        sizeof(float) * dsub);
            continue;
          }
          const float inv = 1.f / (float)counts[c];
          float* cen = cents + c * dsub;
          const float* s = sums.data() + c * dsub;
          for (int t = 0; t < dsub; ++t) cen[t] = s[t] * inv;
        }
      }
    };
    auto run = [&]() {
      int j;
      while ((j = next_j.fetch_add(1)) < pq_m) train_one(j);
    };
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < n_threads; ++t) pool.emplace_back(run);
    for (auto& t : pool) t.join();
    build_sym_tables();
    pq_trained = true;
  }

  // stored node vs stored node (graph construction / link shrinking)
  inline float dist_nn(int64_t a, int64_t b) const {
    if (pq) {
      const uint8_t* ca = pqcodes.data() + a * pq_m;
      const uint8_t* cb = pqcodes.data() + b * pq_m;
      float acc = 0.f;
      for (int j = 0; j < pq_m; ++j)
        acc += pq_sym[((size_t)j << 16) + ((size_t)ca[j] << 8) + cb[j]];
      return acc;
    }
    if (!sq8) return dist(vec(a), vec(b));
    const int8_t* ca = code(a);
    const int8_t* cb = code(b);
    if (metric == METRIC_IP) {
      int32_t acc = 0;  // |dim * 127^2| < 2^31 for dim < 130k
      for (int i = 0; i < dim; ++i) acc += (int32_t)ca[i] * (int32_t)cb[i];
      return -(float)acc * scales[a] * scales[b];
    }
    const float sa = scales[a], sb = scales[b];
    float acc = 0.f;
    for (int i = 0; i < dim; ++i) {
      const float d = (float)ca[i] * sa - (float)cb[i] * sb;
      acc += d * d;
    }
    return acc;
  }

  int random_level() {
    std::uniform_real_distribution<double> u(0.0, 1.0);
    double r = u(rng);
    if (r <= 0.0) r = 1e-12;
    return static_cast<int>(-std::log(r) * level_mult);
  }

  using Cand = std::pair<float, int>;  // (distance, id)

  // query-vs-node distance through whichever storage mode is active; in
  // PQ mode the caller supplies the query's ADC table
  inline float dist_q(const float* q, const float* lut, int64_t id) const {
    return pq ? dist_lut(lut, id) : dist_qn(q, id);
  }

  // beam search within one layer. Returns up to `ef` closest candidates.
  std::vector<Cand> search_layer(const float* q, const float* lut, int ep,
                                 int ef, int level,
                                 bool skip_deleted) const {
    // epoch-tagged per-thread visited buffer (hnswlib's VisitedListPool
    // idea): a fresh zero-filled O(n) vector per query memsets ~10 MB at
    // 10M nodes — milliseconds on the latency-critical single-query path
    // and n_threads x that per batch. The buffer is thread_local, so the
    // threaded batch path needs no locking; epoch wrap re-zeros once per
    // 2^32 queries.
    static thread_local std::vector<uint32_t> visited_tags;
    static thread_local uint32_t visit_epoch = 0;
    if (visited_tags.size() < (size_t)n) visited_tags.assign(n + 1024, 0);
    if (++visit_epoch == 0) {
      std::fill(visited_tags.begin(), visited_tags.end(), 0);
      visit_epoch = 1;
    }
    const uint32_t epoch = visit_epoch;
    auto visited_test_set = [&](int idx) {
      if (visited_tags[idx] == epoch) return true;
      visited_tags[idx] = epoch;
      return false;
    };
    // candidates: min-heap by distance; results: max-heap by distance
    std::priority_queue<Cand, std::vector<Cand>, std::greater<Cand>> cands;
    std::priority_queue<Cand> results;
    const float d0 = dist_q(q, lut, ep);
    visited_test_set(ep);
    cands.push({d0, ep});
    if (!skip_deleted || !deleted[ep]) results.push({d0, ep});

    while (!cands.empty()) {
      const Cand c = cands.top();
      if (!results.empty() && c.first > results.top().first &&
          (int)results.size() >= ef)
        break;
      cands.pop();
      const auto& nbrs = links[c.second][level];
      for (const int nb : nbrs) {
        if (visited_test_set(nb)) continue;
        const float d = dist_q(q, lut, nb);
        if ((int)results.size() < ef ||
            (!results.empty() && d < results.top().first)) {
          cands.push({d, nb});
          if (!skip_deleted || !deleted[nb]) {
            results.push({d, nb});
            if ((int)results.size() > ef) results.pop();
          }
        }
      }
    }
    std::vector<Cand> out(results.size());
    for (int i = (int)results.size() - 1; i >= 0; --i) {
      out[i] = results.top();
      results.pop();
    }
    return out;  // ascending distance
  }

  // neighbor selection heuristic (paper alg. 4): keep a candidate only if
  // it is closer to q than to every already-selected neighbor — preserves
  // graph diversity, which simple closest-M selection loses. (q enters
  // only through the precomputed c.first distances.)
  std::vector<int> select_neighbors(const std::vector<Cand>& cands,
                                    int m) const {
    std::vector<int> selected;
    selected.reserve(m);
    for (const auto& c : cands) {
      if ((int)selected.size() >= m) break;
      bool keep = true;
      for (const int s : selected) {
        if (dist_nn(c.second, s) < c.first) {
          keep = false;
          break;
        }
      }
      if (keep) selected.push_back(c.second);
    }
    // backfill with closest skipped candidates if underfull
    if ((int)selected.size() < m) {
      for (const auto& c : cands) {
        if ((int)selected.size() >= m) break;
        if (std::find(selected.begin(), selected.end(), c.second) ==
            selected.end())
          selected.push_back(c.second);
      }
    }
    return selected;
  }

  void shrink_links(int node, int level) {
    auto& nbrs = links[node][level];
    const int cap = level == 0 ? maxM0 : M;
    if ((int)nbrs.size() <= cap) return;
    std::vector<Cand> cands;
    cands.reserve(nbrs.size());
    for (const int nb : nbrs) cands.push_back({dist_nn(node, nb), nb});
    std::sort(cands.begin(), cands.end());
    nbrs = select_neighbors(cands, cap);
  }

  int64_t add(const float* v) {
    const int64_t id = n++;
    std::vector<float> lut;
    if (pq) {
      pqcodes.resize(pqcodes.size() + pq_m);
      encode_pq(v, pqcodes.data() + id * pq_m);
      lut.resize((size_t)pq_m * 256);
      build_lut(v, lut.data());
    } else if (sq8) {
      float amax = 0.f;
      for (int i = 0; i < dim; ++i) amax = std::max(amax, std::fabs(v[i]));
      const float scale = std::max(amax, 1e-12f) / 127.f;
      scales.push_back(scale);
      const float inv = 1.f / scale;
      codes.reserve(codes.size() + dim);
      for (int i = 0; i < dim; ++i) {
        const float r = std::nearbyint(v[i] * inv);
        codes.push_back((int8_t)std::max(-127.f, std::min(127.f, r)));
      }
    } else {
      data.insert(data.end(), v, v + dim);
    }
    const int level = random_level();
    levels.push_back(level);
    links.emplace_back(level + 1);
    deleted.push_back(0);

    if (entry < 0) {
      entry = (int)id;
      max_level = level;
      return id;
    }
    int cur = entry;
    const float* lutp = pq ? lut.data() : nullptr;
    // greedy descent through levels above the node's level
    for (int lc = max_level; lc > level; --lc) {
      bool improved = true;
      float cur_d = dist_q(v, lutp, cur);
      while (improved) {
        improved = false;
        for (const int nb : links[cur][lc]) {
          const float d = dist_q(v, lutp, nb);
          if (d < cur_d) {
            cur_d = d;
            cur = nb;
            improved = true;
          }
        }
      }
    }
    // connect at each level from min(level, max_level) down to 0
    for (int lc = std::min(level, max_level); lc >= 0; --lc) {
      auto cands =
          search_layer(v, lutp, cur, efc, lc, /*skip_deleted=*/false);
      // insertion selects M neighbors at EVERY level (hnswlib semantics;
      // maxM0 only caps the level-0 shrink limit in shrink_links)
      auto nbrs = select_neighbors(cands, M);
      links[id][lc] = nbrs;
      for (const int nb : nbrs) {
        links[nb][lc].push_back((int)id);
        shrink_links(nb, lc);
      }
      if (!cands.empty()) cur = cands.front().second;
    }
    if (level > max_level) {
      max_level = level;
      entry = (int)id;
    }
    return id;
  }

  void search(const float* q, int k, int ef, float* out_scores,
              int64_t* out_ids) const {
    if (entry < 0 || n == 0) {
      for (int i = 0; i < k; ++i) {
        out_scores[i] = -3.0e38f;
        out_ids[i] = -1;
      }
      return;
    }
    std::vector<float> lut;
    if (pq) {
      lut.resize((size_t)pq_m * 256);
      build_lut(q, lut.data());
    }
    const float* lutp = pq ? lut.data() : nullptr;
    int cur = entry;
    float cur_d = dist_q(q, lutp, cur);
    for (int lc = max_level; lc >= 1; --lc) {
      bool improved = true;
      while (improved) {
        improved = false;
        for (const int nb : links[cur][lc]) {
          const float d = dist_q(q, lutp, nb);
          if (d < cur_d) {
            cur_d = d;
            cur = nb;
            improved = true;
          }
        }
      }
    }
    auto cands =
        search_layer(q, lutp, cur, std::max(ef, k), 0, /*skip_deleted=*/true);
    for (int i = 0; i < k; ++i) {
      if (i < (int)cands.size()) {
        // report score with larger-is-better semantics like the device
        // indexes: ip -> dot product; l2 -> negative squared distance
        out_scores[i] = -cands[i].first;
        out_ids[i] = cands[i].second;
      } else {
        out_scores[i] = -3.0e38f;
        out_ids[i] = -1;
      }
    }
  }
};

}  // namespace

extern "C" {

void* hnsw_create(int dim, int M, int ef_construction, int metric,
                  uint64_t seed, int quant, int pq_m) {
  if (quant == QUANT_PQ && (pq_m <= 0 || dim % pq_m != 0)) return nullptr;
  return new Hnsw(dim, M, ef_construction, metric, seed, quant, pq_m);
}

int hnsw_is_quantized(void* h) {
  const Hnsw* x = static_cast<const Hnsw*>(h);
  return x->pq ? QUANT_PQ : (x->sq8 ? QUANT_SQ8 : QUANT_F32);
}

int hnsw_pq_m(void* h) { return static_cast<Hnsw*>(h)->pq_m; }

int hnsw_is_trained(void* h) {
  const Hnsw* x = static_cast<const Hnsw*>(h);
  return (!x->pq || x->pq_trained) ? 1 : 0;
}

// Train the PQ codebooks on `count` f32 sample rows (call once, before any
// add). Returns 0 on success.
int hnsw_train_pq(void* h, const float* sample, int64_t count) {
  Hnsw* x = static_cast<Hnsw*>(h);
  if (!x->pq || x->pq_trained || count < 256) return -1;
  x->train_pq(sample, count);
  return 0;
}

void hnsw_free(void* h) { delete static_cast<Hnsw*>(h); }

int64_t hnsw_add(void* h, const float* vecs, int64_t count) {
  Hnsw* index = static_cast<Hnsw*>(h);
  if (index->pq && !index->pq_trained) return -1;  // train first
  const int64_t start = index->n;
  for (int64_t i = 0; i < count; ++i) index->add(vecs + i * index->dim);
  return start;
}

void hnsw_search(void* h, const float* queries, int64_t nq, int k, int ef,
                 float* out_scores, int64_t* out_ids) {
  const Hnsw* index = static_cast<const Hnsw*>(h);
  // batch queries fan out across a thread pool: searches only read the
  // graph, so they are embarrassingly parallel (single-writer model —
  // the store's RW lock already serializes adds against searches)
  const int64_t hw = (int64_t)std::thread::hardware_concurrency();
  const int64_t n_threads = std::max<int64_t>(1, std::min<int64_t>({hw, nq, 16}));
  if (n_threads == 1) {
    for (int64_t i = 0; i < nq; ++i)
      index->search(queries + i * index->dim, k, ef, out_scores + i * k,
                    out_ids + i * k);
    return;
  }
  std::atomic<int64_t> next(0);
  auto run = [&]() {
    int64_t i;
    while ((i = next.fetch_add(1)) < nq)
      index->search(queries + i * index->dim, k, ef, out_scores + i * k,
                    out_ids + i * k);
  };
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int64_t t = 0; t < n_threads; ++t) pool.emplace_back(run);
  for (auto& t : pool) t.join();
}

// returns the number of rows NEWLY tombstoned (duplicates and
// already-deleted ids don't count — callers keep n_deleted exact)
int64_t hnsw_mark_deleted(void* h, const int64_t* ids, int64_t count) {
  Hnsw* index = static_cast<Hnsw*>(h);
  int64_t newly = 0;
  for (int64_t i = 0; i < count; ++i)
    if (ids[i] >= 0 && ids[i] < index->n && !index->deleted[ids[i]]) {
      index->deleted[ids[i]] = 1;
      ++newly;
    }
  return newly;
}

int64_t hnsw_size(void* h) { return static_cast<Hnsw*>(h)->n; }

int64_t hnsw_count_deleted(void* h) {
  const Hnsw* x = static_cast<const Hnsw*>(h);
  int64_t count = 0;
  for (const uint8_t d : x->deleted) count += d;
  return count;
}

int hnsw_get_vector(void* h, int64_t id, float* out) {
  const Hnsw* index = static_cast<const Hnsw*>(h);
  if (id < 0 || id >= index->n) {
    // -1 is the search API's miss sentinel: an unchecked pass-through
    // here read out of bounds (garbage vectors or a segfault)
    std::memset(out, 0, sizeof(float) * index->dim);
    return -1;
  }
  if (index->pq) {
    const uint8_t* cd = index->pqcodes.data() + id * index->pq_m;
    for (int j = 0; j < index->pq_m; ++j)
      std::memcpy(out + j * index->dsub, index->centroid(j, cd[j]),
                  sizeof(float) * index->dsub);
    return 0;
  }
  if (index->sq8) {
    const int8_t* c = index->code(id);
    const float s = index->scales[id];
    for (int i = 0; i < index->dim; ++i) out[i] = (float)c[i] * s;
    return 0;
  }
  std::memcpy(out, index->vec(id), sizeof(float) * index->dim);
  return 0;
}

// -- binary snapshot ------------------------------------------------------

int hnsw_save(void* h, const char* path) {
  const Hnsw* x = static_cast<const Hnsw*>(h);
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  // V3 header carries the quant mode (0=f32, 1=sq8, 2=pq) and pq_m; PQ
  // payload = codebooks + per-node codes (sym tables rebuilt at load).
  // V2 (sq8 flag) and V1 (f32) files still load.
  const char magic[8] = {'R', 'A', 'T', 'H', 'N', 'S', 'W', '3'};
  // every write checked: a disk-full mid-save that reported rc=0 produced
  // a truncated snapshot only discovered when hnsw_load fails at restore
  bool ok = true;
  auto W = [&](const void* p, size_t sz, size_t cnt) {
    ok = ok && std::fwrite(p, sz, cnt, f) == cnt;
  };
  W(magic, 1, 8);
  const int32_t quant = x->pq ? QUANT_PQ : (x->sq8 ? QUANT_SQ8 : QUANT_F32);
  int32_t header[7] = {x->dim,           x->M,         x->efc,
                       (int32_t)x->metric, x->max_level, quant, x->pq_m};
  W(header, sizeof(int32_t), 7);
  int64_t meta[2] = {x->n, (int64_t)x->entry};
  W(meta, sizeof(int64_t), 2);
  if (x->pq) {
    W(x->pq_centroids.data(), sizeof(float), x->pq_centroids.size());
    W(x->pqcodes.data(), 1, x->pqcodes.size());
  } else if (x->sq8) {
    W(x->codes.data(), 1, x->codes.size());
    W(x->scales.data(), sizeof(float), x->scales.size());
  } else {
    W(x->data.data(), sizeof(float), x->data.size());
  }
  W(x->levels.data(), sizeof(int), x->levels.size());
  W(x->deleted.data(), 1, x->deleted.size());
  for (int64_t i = 0; ok && i < x->n; ++i) {
    for (int lc = 0; lc <= x->levels[i]; ++lc) {
      const auto& nbrs = x->links[i][lc];
      const int32_t sz = (int32_t)nbrs.size();
      W(&sz, sizeof(int32_t), 1);
      W(nbrs.data(), sizeof(int), sz);
    }
  }
  if (std::fclose(f) != 0) ok = false;
  return ok ? 0 : -1;
}

void* hnsw_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  char magic[8];
  if (std::fread(magic, 1, 8, f) != 8 ||
      std::memcmp(magic, "RATHNSW", 7) != 0 ||
      (magic[7] < '1' || magic[7] > '3')) {
    std::fclose(f);
    return nullptr;
  }
  const int version = magic[7] - '0';
  int32_t header[7] = {0, 0, 0, 0, 0, 0, 0};
  int64_t meta[2];
  const size_t nh = version >= 3 ? 7 : (version == 2 ? 6 : 5);
  if (std::fread(header, sizeof(int32_t), nh, f) != nh ||
      std::fread(meta, sizeof(int64_t), 2, f) != 2) {
    std::fclose(f);
    return nullptr;
  }
  // header[5] is the V2 sq8 flag or the V3 quant enum — same values for
  // f32/sq8, so one constructor path covers both
  Hnsw* x = new Hnsw(header[0], header[1], header[2], header[3], 0,
                     header[5], header[6]);
  x->max_level = header[4];
  x->n = meta[0];
  x->entry = (int)meta[1];
  x->levels.resize(x->n);
  x->deleted.resize(x->n);
  bool ok = true;
  if (x->pq) {
    x->pq_centroids.resize((size_t)x->pq_m * 256 * x->dsub);
    x->pqcodes.resize(x->n * x->pq_m);
    ok = std::fread(x->pq_centroids.data(), sizeof(float),
                    x->pq_centroids.size(), f) == x->pq_centroids.size();
    ok = ok && std::fread(x->pqcodes.data(), 1, x->pqcodes.size(), f) ==
                   x->pqcodes.size();
    if (ok) {
      x->build_sym_tables();
      x->pq_trained = true;
    }
  } else if (x->sq8) {
    x->codes.resize(x->n * x->dim);
    x->scales.resize(x->n);
    ok = std::fread(x->codes.data(), 1, x->codes.size(), f) == x->codes.size();
    ok = ok && std::fread(x->scales.data(), sizeof(float), x->n, f) ==
                   (size_t)x->n;
  } else {
    x->data.resize(x->n * x->dim);
    ok = std::fread(x->data.data(), sizeof(float), x->data.size(), f) ==
         x->data.size();
  }
  ok = ok && std::fread(x->levels.data(), sizeof(int), x->n, f) == (size_t)x->n;
  ok = ok && std::fread(x->deleted.data(), 1, x->n, f) == (size_t)x->n;
  x->links.resize(x->n);
  for (int64_t i = 0; ok && i < x->n; ++i) {
    x->links[i].resize(x->levels[i] + 1);
    for (int lc = 0; ok && lc <= x->levels[i]; ++lc) {
      int32_t sz = 0;
      ok = std::fread(&sz, sizeof(int32_t), 1, f) == 1 && sz >= 0;
      if (ok) {
        x->links[i][lc].resize(sz);
        ok = std::fread(x->links[i][lc].data(), sizeof(int), sz, f) ==
             (size_t)sz;
      }
    }
  }
  std::fclose(f);
  if (!ok) {
    delete x;
    return nullptr;
  }
  return x;
}

}  // extern "C"
