// Host CSR BM25 scorer.
//
// Term-at-a-time scoring over term-major postings with fully precomputed
// per-(term, doc) BM25 weights — the classic inverted-index engine the
// reference delegated to rank_bm25 (python, dense) and tantivy (Rust).
// Complements the device kernel (ops/bm25.py): selective queries touch
// only their posting lists (~df(t) entries/term), where the dense device
// layout pays O(N·Dmax) per term. The bench (tools/bm25_bench.py) decides
// which backend a given corpus/batch shape should use.
//
// Concurrency: queries in a batch are scored by a pool of worker threads;
// each worker owns a dense accumulator + epoch-tag array (no memset per
// query — a doc is "touched" iff tag[doc] == current epoch) and a list of
// touched docs so top-k scans only touched entries.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Worker {
  std::vector<float> acc;
  std::vector<uint32_t> tag;
  std::vector<int32_t> touched;
  uint32_t epoch = 0;
};

struct Postings {
  int64_t n_docs = 0;
  int64_t n_vocab = 0;
  std::vector<int64_t> offsets;  // n_vocab + 1, into docs/weights
  std::vector<int32_t> docs;     // nnz
  std::vector<float> weights;    // nnz — idf·tf·(k1+1)/(tf+k1·(1−b+b·len/avgdl))
  // reusable per-thread scratch: acc+tag are 8 bytes/doc — 80 MB at 10M
  // docs, far too much to allocate+zero per search call (the epoch tags
  // exist precisely so the arrays never need re-zeroing). Concurrent
  // searches on one handle each check a distinct Worker out of the pool.
  std::mutex pool_mu;
  std::vector<std::unique_ptr<Worker>> pool;

  std::unique_ptr<Worker> acquire_worker() {
    {
      std::lock_guard<std::mutex> g(pool_mu);
      if (!pool.empty()) {
        auto w = std::move(pool.back());
        pool.pop_back();
        return w;
      }
    }
    auto w = std::make_unique<Worker>();
    w->acc.assign(n_docs, 0.0f);
    w->tag.assign(n_docs, 0);
    return w;
  }

  void release_worker(std::unique_ptr<Worker> w) {
    std::lock_guard<std::mutex> g(pool_mu);
    pool.push_back(std::move(w));
  }
};

}  // namespace

extern "C" {

void* bm25host_build(const int64_t* row_offsets, const int32_t* term_ids,
                     const float* tfs, const int64_t* doc_len,
                     const int64_t* df, int64_t n_docs, int64_t n_vocab,
                     double k1, double b, double epsilon) {
  auto* p = new Postings();
  p->n_docs = n_docs;
  p->n_vocab = n_vocab;
  const int64_t nnz = row_offsets[n_docs];

  // idf with the BM25Okapi epsilon floor (ops/bm25.py compute_idf parity):
  // rank_bm25 averages over every CORPUS term's idf (negatives included);
  // df=0 filler ids in sparse id spaces are excluded — BM25Okapi's idf
  // dict only ever holds corpus terms, and their big positive idf would
  // inflate the floor
  std::vector<double> idf(n_vocab);
  double idf_sum = 0.0;
  int64_t n_present = 0;
  for (int64_t t = 0; t < n_vocab; ++t) {
    idf[t] = std::log((n_docs - df[t] + 0.5) / (df[t] + 0.5));
    if (df[t] > 0) { idf_sum += idf[t]; ++n_present; }
  }
  const double eps_floor = epsilon * (n_present ? idf_sum / n_present : 1.0);
  for (int64_t t = 0; t < n_vocab; ++t)
    if (idf[t] < 0) idf[t] = eps_floor;

  double len_sum = 0.0;
  for (int64_t d = 0; d < n_docs; ++d) len_sum += (double)doc_len[d];
  const double avgdl = n_docs ? len_sum / n_docs : 1e-9;

  // invert doc-major CSR into term-major postings (counting sort by term)
  p->offsets.assign(n_vocab + 1, 0);
  for (int64_t i = 0; i < nnz; ++i) p->offsets[term_ids[i] + 1]++;
  for (int64_t t = 0; t < n_vocab; ++t) p->offsets[t + 1] += p->offsets[t];
  p->docs.resize(nnz);
  p->weights.resize(nnz);
  std::vector<int64_t> cursor(p->offsets.begin(), p->offsets.end() - 1);
  for (int64_t d = 0; d < n_docs; ++d) {
    const double norm =
        k1 * (1.0 - b + b * (double)doc_len[d] / std::max(avgdl, 1e-9));
    for (int64_t i = row_offsets[d]; i < row_offsets[d + 1]; ++i) {
      const int32_t t = term_ids[i];
      const double tf = (double)tfs[i];
      const int64_t at = cursor[t]++;
      p->docs[at] = (int32_t)d;
      p->weights[at] = (float)(idf[t] * tf * (k1 + 1.0) / (tf + norm));
    }
  }
  return p;
}

void bm25host_free(void* h) { delete static_cast<Postings*>(h); }

// Dense score vector for one query (get_scores parity).
void bm25host_scores(void* h, const int32_t* q_terms, const float* q_counts,
                     int64_t n_terms, float* out) {
  const Postings* p = static_cast<const Postings*>(h);
  std::memset(out, 0, p->n_docs * sizeof(float));
  for (int64_t j = 0; j < n_terms; ++j) {
    const int32_t t = q_terms[j];
    if (t < 0 || t >= p->n_vocab) continue;
    const float c = q_counts[j];
    for (int64_t i = p->offsets[t]; i < p->offsets[t + 1]; ++i)
      out[p->docs[i]] += c * p->weights[i];
  }
}

// Batched top-k. q_offsets (n_queries + 1) delimits each query's slice of
// q_terms/q_counts. valid may be null (= all docs live). Results are
// score-descending; empty slots carry score -inf / position -1.
void bm25host_search(void* h, const int32_t* q_terms, const float* q_counts,
                     const int64_t* q_offsets, int64_t n_queries, int32_t k,
                     const uint8_t* valid, float* out_scores,
                     int64_t* out_pos, int32_t n_threads) {
  Postings* p = static_cast<Postings*>(h);
  if (n_threads <= 0) n_threads = 1;
  std::atomic<int64_t> next(0);

  auto run = [&]() {
    auto wp = p->acquire_worker();
    Worker& w = *wp;
    int64_t q;
    while ((q = next.fetch_add(1)) < n_queries) {
      if (++w.epoch == 0) {  // uint32 wrap: stale tags could false-match
        std::fill(w.tag.begin(), w.tag.end(), 0u);
        w.epoch = 1;
      }
      w.touched.clear();
      for (int64_t j = q_offsets[q]; j < q_offsets[q + 1]; ++j) {
        const int32_t t = q_terms[j];
        if (t < 0 || t >= p->n_vocab) continue;
        const float c = q_counts[j];
        for (int64_t i = p->offsets[t]; i < p->offsets[t + 1]; ++i) {
          const int32_t d = p->docs[i];
          if (w.tag[d] != w.epoch) {
            w.tag[d] = w.epoch;
            w.acc[d] = 0.0f;
            w.touched.push_back(d);
          }
          w.acc[d] += c * p->weights[i];
        }
      }
      // top-k over touched docs via a min-heap of (score, doc)
      using Entry = std::pair<float, int64_t>;
      std::vector<Entry> heap;
      heap.reserve(k + 1);
      auto cmp = [](const Entry& a, const Entry& b) {
        return a.first > b.first ||
               (a.first == b.first && a.second < b.second);
      };
      for (const int32_t d : w.touched) {
        if (valid && !valid[d]) continue;
        const Entry e{w.acc[d], (int64_t)d};
        if ((int32_t)heap.size() < k) {
          heap.push_back(e);
          std::push_heap(heap.begin(), heap.end(), cmp);
        } else if (cmp(e, heap.front())) {
          std::pop_heap(heap.begin(), heap.end(), cmp);
          heap.back() = e;
          std::push_heap(heap.begin(), heap.end(), cmp);
        }
      }
      std::sort_heap(heap.begin(), heap.end(), cmp);
      // dense-scoring parity (rank_bm25 argsort over a dense vector):
      // untouched docs carry score 0, so they MERGE with the touched
      // top-k, not merely pad it — with a negative idf floor (stopword-
      // heavy corpora) matched docs can score below zero and must rank
      // BELOW zero-scored non-matching docs, exactly as the dense
      // backends order them
      int64_t filler = 0;
      auto next_filler = [&]() -> int64_t {
        while (filler < p->n_docs &&
               ((w.tag[filler] == w.epoch) || (valid && !valid[filler])))
          ++filler;
        return filler < p->n_docs ? filler : -1;
      };
      size_t hi = 0;
      for (int32_t i = 0; i < k; ++i) {
        const bool have_t = hi < heap.size();
        const int64_t f = next_filler();
        // touched beats filler on score > 0, or on lower index at 0
        const bool take_t =
            have_t && (f < 0 || heap[hi].first > 0.0f ||
                       (heap[hi].first == 0.0f && heap[hi].second < f));
        if (take_t) {
          out_scores[q * k + i] = heap[hi].first;
          out_pos[q * k + i] = heap[hi].second;
          ++hi;
        } else if (f >= 0) {
          out_scores[q * k + i] = 0.0f;
          out_pos[q * k + i] = f;
          ++filler;
        } else if (have_t) {  // negatives, no zero docs left
          out_scores[q * k + i] = heap[hi].first;
          out_pos[q * k + i] = heap[hi].second;
          ++hi;
        } else {
          out_scores[q * k + i] = -INFINITY;
          out_pos[q * k + i] = -1;
        }
      }
    }
    p->release_worker(std::move(wp));
  };

  if (n_threads == 1 || n_queries == 1) {
    run();
    return;
  }
  std::vector<std::thread> pool;
  const int32_t spawn = (int32_t)std::min<int64_t>(n_threads, n_queries);
  pool.reserve(spawn);
  for (int32_t i = 0; i < spawn; ++i) pool.emplace_back(run);
  for (auto& t : pool) t.join();
}

}  // extern "C"
