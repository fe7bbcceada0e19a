// Native slot-text parser: the hot half of the host data pipeline.
//
// TPU-native counterpart of the reference's C++ reader stack
// (SlotPaddleBoxDataFeed::ParseOneInstance, data_feed.cc:3202, and the
// pooled multi-threaded LoadIntoMemoryByLine machinery, data_feed.cc:2854):
// the reference parses into per-record SlotRecord structs drawn from an
// object pool; here a whole buffer parses straight into columnar CSR vectors
// (keys + offsets + dense + labels), which the Python side wraps as one
// RecordBlock with zero per-record objects.
//
// Exposed via a plain C ABI for ctypes (no pybind11 in the image).  Python
// threads call pbx_parse_buffer concurrently; the GIL is released during the
// call, so file-level parallelism scales across cores.
//
// Line format (slot_parser.py docstring is the source of truth):
//   [ins_id] [search_id:rank:cmatch] <n> v1..vn  <n> v1..vn ...
// Walk kinds: 0=skip, 1=label, 2=task, 3=dense, 4=sparse.
//
// The same source as the JAX package's _native/slot_parser.cpp, so the two
// packages' RecordBlocks are bit-exact.  The port's DataFeedConfig does not
// take ins_id, logkey or task-label parsing yet, so its SlotParser passes
// none of them; the walk and the ABI keep them.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Result {
  int64_t n_ins = 0;
  std::vector<uint64_t> keys;
  std::vector<int64_t> key_offsets;  // n_ins * n_sparse + 1
  std::vector<float> dense;          // n_ins * dense_width
  std::vector<float> labels;
  std::vector<float> tasks;  // n_ins * n_tasks
  std::vector<uint64_t> search_ids;
  std::vector<int32_t> ranks;
  std::vector<int32_t> cmatches;
  std::vector<char> ins_id_buf;       // concatenated ids
  std::vector<int64_t> ins_id_offs;   // n_ins + 1
};

struct Cursor {
  const char* p;
  const char* end;
};

inline void skip_ws(Cursor& c) {
  while (c.p < c.end && (*c.p == ' ' || *c.p == '\t' || *c.p == '\r')) ++c.p;
}

// next whitespace-delimited token; returns false at end of line
inline bool next_tok(Cursor& c, const char** tok, size_t* len) {
  skip_ws(c);
  if (c.p >= c.end) return false;
  const char* start = c.p;
  while (c.p < c.end && *c.p != ' ' && *c.p != '\t' && *c.p != '\r') ++c.p;
  *tok = start;
  *len = static_cast<size_t>(c.p - start);
  return true;
}

inline bool parse_u64(const char* t, size_t n, uint64_t* out) {
  if (n == 0) return false;
  uint64_t v = 0;
  for (size_t i = 0; i < n; ++i) {
    if (t[i] < '0' || t[i] > '9') return false;
    uint64_t d = static_cast<uint64_t>(t[i] - '0');
    // reject > 2^64-1 instead of silently wrapping (the Python parser
    // raises OverflowError on the same input)
    if (v > (UINT64_MAX - d) / 10u) return false;
    v = v * 10u + d;
  }
  *out = v;
  return true;
}

inline bool parse_i64(const char* t, size_t n, int64_t* out) {
  if (n == 0) return false;
  bool neg = false;
  size_t i = 0;
  if (t[0] == '-') { neg = true; i = 1; if (n == 1) return false; }
  uint64_t v = 0;
  // reject magnitudes outside int64 instead of silently wrapping (the
  // Python parser raises on the same input — parity on malformed data)
  const uint64_t limit =
      neg ? (static_cast<uint64_t>(INT64_MAX) + 1u)
          : static_cast<uint64_t>(INT64_MAX);
  for (; i < n; ++i) {
    if (t[i] < '0' || t[i] > '9') return false;
    uint64_t d = static_cast<uint64_t>(t[i] - '0');
    if (v > (limit - d) / 10u) return false;
    v = v * 10u + d;
  }
  // negate in unsigned: -static_cast<int64_t>(2^63) would be signed overflow
  *out = static_cast<int64_t>(neg ? 0u - v : v);
  return true;
}

inline bool parse_f32(const char* t, size_t n, float* out) {
  // strtof needs NUL termination; tokens are short, copy to a stack buffer
  char buf[64];
  if (n == 0 || n >= sizeof(buf)) return false;
  std::memcpy(buf, t, n);
  buf[n] = '\0';
  char* endp = nullptr;
  *out = std::strtof(buf, &endp);
  return endp == buf + n;
}

void set_err(char* err, size_t errlen, int64_t lineno, const char* msg) {
  if (err && errlen) std::snprintf(err, errlen, "line %lld: %s",
                                   static_cast<long long>(lineno), msg);
}

}  // namespace

extern "C" {

// Returns an opaque Result* (nullptr on error; err holds the message).
void* pbx_parse_buffer(const char* data, int64_t len, const int8_t* kinds,
                       const int32_t* widths, const int32_t* cols, int n_walk,
                       int n_sparse, int dense_width, int n_tasks,
                       int parse_ins_id, int parse_logkey, char* err,
                       int64_t errlen) {
  auto* r = new Result();
  r->key_offsets.push_back(0);
  if (parse_ins_id) r->ins_id_offs.push_back(0);
  const char* p = data;
  const char* end = data + len;
  int64_t lineno = 0;
  std::vector<int64_t> slot_counts(static_cast<size_t>(n_sparse));
  while (p < end) {
    const char* nl = static_cast<const char*>(
        memchr(p, '\n', static_cast<size_t>(end - p)));
    const char* line_end = nl ? nl : end;
    ++lineno;
    Cursor c{p, line_end};
    p = nl ? nl + 1 : end;
    skip_ws(c);
    if (c.p >= c.end) continue;  // blank line

    const char* tok;
    size_t tl;
    if (parse_ins_id) {
      if (!next_tok(c, &tok, &tl)) { set_err(err, errlen, lineno, "missing ins_id"); delete r; return nullptr; }
      r->ins_id_buf.insert(r->ins_id_buf.end(), tok, tok + tl);
      r->ins_id_offs.push_back(static_cast<int64_t>(r->ins_id_buf.size()));
    }
    if (parse_logkey) {
      if (!next_tok(c, &tok, &tl)) { set_err(err, errlen, lineno, "missing logkey"); delete r; return nullptr; }
      // sid:rank:cmatch
      const char* c1 = static_cast<const char*>(memchr(tok, ':', tl));
      if (!c1) { set_err(err, errlen, lineno, "bad logkey"); delete r; return nullptr; }
      const char* c2 = static_cast<const char*>(
          memchr(c1 + 1, ':', static_cast<size_t>(tok + tl - c1 - 1)));
      if (!c2) { set_err(err, errlen, lineno, "bad logkey"); delete r; return nullptr; }
      uint64_t sid;
      int64_t rk, cm;
      if (!parse_u64(tok, static_cast<size_t>(c1 - tok), &sid) ||
          !parse_i64(c1 + 1, static_cast<size_t>(c2 - c1 - 1), &rk) ||
          !parse_i64(c2 + 1, static_cast<size_t>(tok + tl - c2 - 1), &cm) ||
          rk < INT32_MIN || rk > INT32_MAX || cm < INT32_MIN ||
          cm > INT32_MAX) {
        set_err(err, errlen, lineno, "bad logkey"); delete r; return nullptr;
      }
      r->search_ids.push_back(sid);
      r->ranks.push_back(static_cast<int32_t>(rk));
      r->cmatches.push_back(static_cast<int32_t>(cm));
    }

    size_t dense_base = r->dense.size();
    r->dense.resize(dense_base + static_cast<size_t>(dense_width), 0.0f);
    size_t task_base = r->tasks.size();
    r->tasks.resize(task_base + static_cast<size_t>(n_tasks), 0.0f);
    float label = 0.0f;
    std::fill(slot_counts.begin(), slot_counts.end(), 0);

    for (int w = 0; w < n_walk; ++w) {
      if (!next_tok(c, &tok, &tl)) { set_err(err, errlen, lineno, "truncated instance (missing slot count)"); delete r; return nullptr; }
      int64_t n;
      if (!parse_i64(tok, tl, &n) || n < 0) { set_err(err, errlen, lineno, "bad slot count"); delete r; return nullptr; }
      int kind = kinds[w];
      if (kind == 4) {  // sparse
        for (int64_t j = 0; j < n; ++j) {
          if (!next_tok(c, &tok, &tl)) { set_err(err, errlen, lineno, "truncated sparse slot"); delete r; return nullptr; }
          uint64_t k;
          if (!parse_u64(tok, tl, &k)) { set_err(err, errlen, lineno, "bad feasign"); delete r; return nullptr; }
          r->keys.push_back(k);
        }
        slot_counts[static_cast<size_t>(cols[w])] = n;
      } else if (kind == 0) {  // skip
        for (int64_t j = 0; j < n; ++j) {
          if (!next_tok(c, &tok, &tl)) { set_err(err, errlen, lineno, "truncated skipped slot"); delete r; return nullptr; }
        }
      } else {  // label / task / dense: fixed width float block
        if (n != widths[w]) { set_err(err, errlen, lineno, "dense/label slot value count mismatch"); delete r; return nullptr; }
        for (int64_t j = 0; j < n; ++j) {
          if (!next_tok(c, &tok, &tl)) { set_err(err, errlen, lineno, "truncated float slot"); delete r; return nullptr; }
          float v;
          if (!parse_f32(tok, tl, &v)) { set_err(err, errlen, lineno, "bad float"); delete r; return nullptr; }
          if (kind == 1) { if (j == 0) label = v; }
          else if (kind == 2) { if (j == 0) r->tasks[task_base + static_cast<size_t>(cols[w])] = v; }
          else r->dense[dense_base + static_cast<size_t>(cols[w] + j)] = v;
        }
      }
    }
    skip_ws(c);
    if (c.p < c.end) { set_err(err, errlen, lineno, "trailing tokens"); delete r; return nullptr; }
    for (int s = 0; s < n_sparse; ++s)
      r->key_offsets.push_back(r->key_offsets.back() + slot_counts[static_cast<size_t>(s)]);
    r->labels.push_back(label);
    ++r->n_ins;
  }
  return r;
}

int64_t pbx_n_ins(void* h) { return static_cast<Result*>(h)->n_ins; }
int64_t pbx_n_keys(void* h) {
  return static_cast<int64_t>(static_cast<Result*>(h)->keys.size());
}
int64_t pbx_ins_id_bytes(void* h) {
  return static_cast<int64_t>(static_cast<Result*>(h)->ins_id_buf.size());
}

// Copy out into caller-allocated numpy buffers (any pointer may be null to
// skip that column).
void pbx_fill(void* h, uint64_t* keys, int64_t* offsets, float* dense,
              float* labels, float* tasks, uint64_t* sids, int32_t* ranks,
              int32_t* cmatches, char* insid_buf, int64_t* insid_offs) {
  auto* r = static_cast<Result*>(h);
  auto cpy = [](auto* dst, const auto& src) {
    if (dst && !src.empty())
      std::memcpy(dst, src.data(), src.size() * sizeof(src[0]));
  };
  cpy(keys, r->keys);
  cpy(offsets, r->key_offsets);
  cpy(dense, r->dense);
  cpy(labels, r->labels);
  cpy(tasks, r->tasks);
  cpy(sids, r->search_ids);
  cpy(ranks, r->ranks);
  cpy(cmatches, r->cmatches);
  cpy(insid_buf, r->ins_id_buf);
  cpy(insid_offs, r->ins_id_offs);
}

void pbx_free(void* h) { delete static_cast<Result*>(h); }

// Batch FNV-1a 64 over concatenated ids (offs: n+1 byte offsets).  Used for
// shuffle routing (reference: XXH64(ins_id) at data_set.cc:1934-1942); the
// JAX package's data/shuffle.py has a numpy fallback of the identical
// function, so routing never depends on whether the native library built.
void pbx_hash_ids(const char* buf, const int64_t* offs, int64_t n,
                  uint64_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint64_t h = 14695981039346656037ULL;
    for (int64_t j = offs[i]; j < offs[i + 1]; ++j) {
      h ^= static_cast<unsigned char>(buf[j]);
      h *= 1099511628211ULL;
    }
    out[i] = h;
  }
}

}  // extern "C"
