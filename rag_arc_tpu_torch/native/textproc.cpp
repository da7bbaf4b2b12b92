// Corpus term-statistics builder for the BM25 device index.
//
// The BM25 build loop (vocab assignment + per-doc term frequencies) is a
// per-token hashmap loop — the kind of host-side data-loader work the
// reference delegated to compiled libraries (rank_bm25's numpy internals,
// tantivy in its examples). This builds the document-major arrays the
// device kernel consumes (see rag_arc_tpu/ops/bm25.py) at C++ speed.
//
// Tokenization contract: ASCII-lowercase + split on ASCII whitespace —
// byte-exact with Python's text.lower().split() for ASCII corpora (the
// Python wrapper falls back to the pure-Python path for non-ASCII input).
// Vocabulary ids are assigned in first-occurrence order, matching the
// Python builder exactly.
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC textproc.cpp -o libtextproc.so

#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct CorpusStats {
  int64_t n_docs = 0;
  int64_t dmax = 0;  // max unique terms in any doc
  std::vector<std::string> vocab;  // id -> term (first-occurrence order)
  std::vector<int64_t> doc_len;    // tokens per doc
  std::vector<int64_t> df;         // docs containing term
  // per-doc sparse (term_id, tf) pairs, CSR-style
  std::vector<int64_t> row_offsets;  // n_docs + 1
  std::vector<int32_t> term_ids;
  std::vector<float> tfs;
};

inline bool is_space(unsigned char c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\f' ||
         c == '\v';
}

CorpusStats* build(const char* buffer, const int64_t* offsets, int64_t n_docs) {
  auto* stats = new CorpusStats();
  stats->n_docs = n_docs;
  stats->row_offsets.reserve(n_docs + 1);
  stats->row_offsets.push_back(0);
  stats->doc_len.resize(n_docs);

  std::unordered_map<std::string, int32_t> vocab;
  vocab.reserve(1 << 16);
  // per-doc scratch: term -> tf (small maps, reused)
  std::unordered_map<int32_t, float> tf;
  std::string token;

  for (int64_t d = 0; d < n_docs; ++d) {
    const char* begin = buffer + offsets[d];
    const char* end = buffer + offsets[d + 1];
    tf.clear();
    int64_t n_tokens = 0;
    const char* p = begin;
    while (p < end) {
      while (p < end && is_space((unsigned char)*p)) ++p;
      if (p >= end) break;
      token.clear();
      while (p < end && !is_space((unsigned char)*p)) {
        char c = *p++;
        if (c >= 'A' && c <= 'Z') c = (char)(c - 'A' + 'a');
        token.push_back(c);
      }
      ++n_tokens;
      auto [it, inserted] =
          vocab.try_emplace(token, (int32_t)stats->vocab.size());
      if (inserted) {
        stats->vocab.push_back(token);
        stats->df.push_back(0);
      }
      tf[it->second] += 1.0f;
    }
    stats->doc_len[d] = n_tokens;
    for (const auto& [tid, count] : tf) {
      stats->term_ids.push_back(tid);
      stats->tfs.push_back(count);
      stats->df[tid] += 1;
    }
    stats->row_offsets.push_back((int64_t)stats->term_ids.size());
    const int64_t uniq = (int64_t)tf.size();
    if (uniq > stats->dmax) stats->dmax = uniq;
  }
  return stats;
}

}  // namespace

extern "C" {

void* textproc_build(const char* buffer, const int64_t* offsets,
                     int64_t n_docs) {
  return build(buffer, offsets, n_docs);
}

void textproc_free(void* h) { delete static_cast<CorpusStats*>(h); }

int64_t textproc_n_vocab(void* h) {
  return (int64_t)static_cast<CorpusStats*>(h)->vocab.size();
}

int64_t textproc_dmax(void* h) { return static_cast<CorpusStats*>(h)->dmax; }

int64_t textproc_nnz(void* h) {
  return (int64_t)static_cast<CorpusStats*>(h)->term_ids.size();
}

// fill caller-allocated arrays: row_offsets (n_docs+1), term_ids (nnz),
// tfs (nnz), doc_len (n_docs), df (n_vocab)
void textproc_export(void* h, int64_t* row_offsets, int32_t* term_ids,
                     float* tfs, int64_t* doc_len, int64_t* df) {
  const auto* s = static_cast<CorpusStats*>(h);
  std::memcpy(row_offsets, s->row_offsets.data(),
              s->row_offsets.size() * sizeof(int64_t));
  std::memcpy(term_ids, s->term_ids.data(),
              s->term_ids.size() * sizeof(int32_t));
  std::memcpy(tfs, s->tfs.data(), s->tfs.size() * sizeof(float));
  std::memcpy(doc_len, s->doc_len.data(), s->doc_len.size() * sizeof(int64_t));
  std::memcpy(df, s->df.data(), s->df.size() * sizeof(int64_t));
}

// vocabulary export: total byte length of '\n'-joined terms, then the bytes
int64_t textproc_vocab_bytes(void* h) {
  const auto* s = static_cast<CorpusStats*>(h);
  int64_t total = 0;
  for (const auto& t : s->vocab) total += (int64_t)t.size() + 1;
  return total;
}

void textproc_vocab_export(void* h, char* out) {
  const auto* s = static_cast<CorpusStats*>(h);
  for (const auto& t : s->vocab) {
    std::memcpy(out, t.data(), t.size());
    out += t.size();
    *out++ = '\n';
  }
}

}  // extern "C"
