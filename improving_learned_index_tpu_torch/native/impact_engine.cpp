// Native query engine over the binary inverted-index format.
//
// Host-side serving counterpart to the device scorer: the reference
// delegates production query processing to Anserini/PISA (README route
// Anserini -> CIFF -> PISA) and ships a Python struct-unpack loop as its own
// engine (src/deep_impact/inverted_index/inverted_index.py:41-62).  This
// re-owns that capability natively: mmap the postings (.dat) and offsets
// (.idx), TAAT-accumulate quantized impacts into a dense score array, and
// select top-k with a bounded heap.  Zero-impact postings terminate a list,
// matching the reference's read loop.
//
// Exposed as a C ABI for ctypes (no pybind11 in the image).
//
// Build: make -C improving_learned_index_tpu/native  (g++ -O3 -shared -fPIC)

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

#pragma pack(push, 1)
struct Posting {
  uint32_t doc_id;
  uint8_t impact;
};
#pragma pack(pop)
static_assert(sizeof(Posting) == 5, "posting record must be 5 bytes");

struct MappedFile {
  const uint8_t* data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open(const std::string& path) {
    fd = ::open(path.c_str(), O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0) return false;
    size = static_cast<size_t>(st.st_size);
    if (size == 0) {
      data = nullptr;
      return true;
    }
    void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) return false;
    data = static_cast<const uint8_t*>(p);
    return true;
  }

  ~MappedFile() {
    if (data && size) munmap(const_cast<uint8_t*>(data), size);
    if (fd >= 0) close(fd);
  }
};

struct Engine {
  std::unordered_map<std::string, int64_t> vocab;
  std::vector<uint64_t> starts;  // byte offsets into .dat
  std::vector<uint64_t> ends;
  MappedFile dat;
  uint32_t num_docs = 0;
  // reusable accumulator (single-threaded engine instance)
  std::vector<uint32_t> acc;
  std::vector<uint32_t> touched;
};

const Posting* postings_at(const Engine& e, uint64_t byte_off) {
  return reinterpret_cast<const Posting*>(e.dat.data + byte_off);
}

}  // namespace

extern "C" {

void* ili_open(const char* index_dir) {
  auto e = new Engine();
  std::string dir(index_dir);

  std::ifstream vf(dir + "/vocab.txt");
  if (!vf.is_open()) {
    delete e;
    return nullptr;
  }
  std::string line;
  int64_t tid = 0;
  while (std::getline(vf, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    e->vocab.emplace(line, tid++);
  }

  MappedFile idx;
  if (!idx.open(dir + "/inverted_index.idx") || !e->dat.open(dir + "/inverted_index.dat")) {
    delete e;
    return nullptr;
  }
  size_t n_terms = idx.size / 16;
  if (n_terms != e->vocab.size()) {
    delete e;
    return nullptr;
  }
  e->starts.resize(n_terms);
  e->ends.resize(n_terms);
  const uint64_t* locs = reinterpret_cast<const uint64_t*>(idx.data);
  for (size_t i = 0; i < n_terms; ++i) {
    e->starts[i] = locs[2 * i];
    e->ends[i] = locs[2 * i + 1];
  }

  // one scan for the doc-id space (needed for the dense accumulator)
  size_t n_postings = e->dat.size / sizeof(Posting);
  const Posting* p = postings_at(*e, 0);
  uint32_t max_doc = 0;
  for (size_t i = 0; i < n_postings; ++i) max_doc = std::max(max_doc, p[i].doc_id);
  e->num_docs = n_postings ? max_doc + 1 : 0;
  e->acc.assign(e->num_docs, 0);
  return e;
}

void ili_close(void* handle) { delete static_cast<Engine*>(handle); }

int64_t ili_num_terms(void* handle) {
  return static_cast<Engine*>(handle)->vocab.size();
}

int64_t ili_num_docs(void* handle) {
  return static_cast<Engine*>(handle)->num_docs;
}

int64_t ili_term_id(void* handle, const char* term) {
  auto& e = *static_cast<Engine*>(handle);
  auto it = e.vocab.find(term);
  return it == e.vocab.end() ? -1 : it->second;
}

// Score one query (term ids, -1 entries ignored).  Returns the number of
// results written to out_docs/out_scores (impact-sum descending).
int64_t ili_score(void* handle, const int64_t* term_ids, int64_t n_terms,
                  int64_t top_k, uint32_t* out_docs, uint32_t* out_scores) {
  auto& e = *static_cast<Engine*>(handle);
  if (e.num_docs == 0) return 0;
  e.touched.clear();

  for (int64_t t = 0; t < n_terms; ++t) {
    int64_t tid = term_ids[t];
    if (tid < 0 || tid >= static_cast<int64_t>(e.starts.size())) continue;
    const Posting* p = postings_at(e, e.starts[tid]);
    size_t n = (e.ends[tid] - e.starts[tid]) / sizeof(Posting);
    for (size_t i = 0; i < n; ++i) {
      if (p[i].impact == 0) break;  // reference term_docs stops at zero
      if (e.acc[p[i].doc_id] == 0) e.touched.push_back(p[i].doc_id);
      e.acc[p[i].doc_id] += p[i].impact;
    }
  }

  int64_t k = std::min<int64_t>(top_k, e.touched.size());
  if (k > 0) {
    auto cmp = [&](uint32_t a, uint32_t b) {
      return e.acc[a] != e.acc[b] ? e.acc[a] > e.acc[b] : a < b;
    };
    std::partial_sort(e.touched.begin(), e.touched.begin() + k, e.touched.end(), cmp);
    for (int64_t i = 0; i < k; ++i) {
      out_docs[i] = e.touched[i];
      out_scores[i] = e.acc[e.touched[i]];
    }
  }
  // reset accumulator for the touched docs only
  for (uint32_t d : e.touched) e.acc[d] = 0;
  return k;
}

// Batch scoring: queries flattened into term_ids with row offsets.
// out arrays are [n_queries * top_k]; out_counts[q] = results for query q.
int64_t ili_score_batch(void* handle, const int64_t* term_ids,
                        const int64_t* query_offsets, int64_t n_queries,
                        int64_t top_k, uint32_t* out_docs, uint32_t* out_scores,
                        int64_t* out_counts) {
  for (int64_t q = 0; q < n_queries; ++q) {
    const int64_t* ids = term_ids + query_offsets[q];
    int64_t n = query_offsets[q + 1] - query_offsets[q];
    out_counts[q] = ili_score(handle, ids, n, top_k, out_docs + q * top_k,
                              out_scores + q * top_k);
  }
  return n_queries;
}

}  // extern "C"
