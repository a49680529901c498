// Native host-side IO for the columnar fast path.
//
// The reference's engine is native (Rust/Timely); here the native
// surface is the host data plane that feeds the TPU: a zero-copy text
// parser turning 1BRC-style "station;-12.3\n" bytes into
// dictionary-encoded (key_id, deci-degree) columns, plus a generic
// newline chunker.  Python binds via ctypes (build: see
// bytewax_tpu_torch/native/__init__.py).
//
// Reference workload: upstream bytewax examples/1brc.py (the reference
// parses per-line in Python; this parser feeds the same rows to the
// device at memory bandwidth).

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// Incrementally-grown string dictionary: ids are assigned in first-
// sight order and never change (downstream device state keys on id
// identity across batches).
struct VocabSet {
  std::unordered_map<std::string, int32_t> index;
  std::vector<std::string> entries;

  int32_t intern(const char* s, size_t n) {
    std::string key(s, n);
    auto it = index.find(key);
    if (it != index.end()) return it->second;
    int32_t id = static_cast<int32_t>(entries.size());
    entries.push_back(key);
    index.emplace(std::move(key), id);
    return id;
  }
};

struct BrcParser {
  VocabSet vocab;
};

// Word tokenizer for the wordcount fast path: splits lowered text on
// the same separator set as the Python-tier regex
// [^\s!,.?":;0-9]+ (models/wordcount.py), restricted to ASCII
// semantics — callers route non-ASCII lines through the Python
// regex (bytes >= 0x80 are treated as word chars here, identical to
// the regex for ASCII-whitespace-separated text).
struct WordTokenizer {
  VocabSet vocab;
  bool stop[256] = {};

  WordTokenizer() {
    // Mirrors TOKEN_RE in bytewax_tpu_torch/ops/text.py: ASCII \s per
    // Python (space, \t-\r, and the \x1c-\x1f separators) plus the
    // listed punctuation and digits.  Keep the three in sync (the
    // parity test covers the edges).
    for (int c : {(int)' ', (int)'\t', (int)'\n', (int)'\r', (int)'\v',
                  (int)'\f', 0x1c, 0x1d, 0x1e, 0x1f, (int)'!', (int)',',
                  (int)'.', (int)'?', (int)'"', (int)':', (int)';'}) {
      stop[c] = true;
    }
    for (int c = '0'; c <= '9'; ++c) stop[c] = true;
  }
};

int32_t vocab_get(const VocabSet& v, int32_t i, char* out, int32_t cap) {
  if (i < 0 || i >= static_cast<int32_t>(v.entries.size())) return -1;
  const std::string& s = v.entries[i];
  int32_t n = static_cast<int32_t>(s.size());
  if (n > cap) return -n;
  std::memcpy(out, s.data(), n);
  return n;
}

}  // namespace

extern "C" {

BrcParser* brc_parser_new() { return new BrcParser(); }

void brc_parser_free(BrcParser* p) { delete p; }

int32_t brc_vocab_size(const BrcParser* p) {
  return static_cast<int32_t>(p->vocab.entries.size());
}

int32_t brc_vocab_get(const BrcParser* p, int32_t i, char* out, int32_t cap) {
  return vocab_get(p->vocab, i, out, cap);
}

WordTokenizer* wc_new() { return new WordTokenizer(); }

void wc_free(WordTokenizer* p) { delete p; }

int32_t wc_vocab_size(const WordTokenizer* p) {
  return static_cast<int32_t>(p->vocab.entries.size());
}

int32_t wc_vocab_get(const WordTokenizer* p, int32_t i, char* out,
                     int32_t cap) {
  return vocab_get(p->vocab, i, out, cap);
}

// Tokenize a text buffer into dictionary-encoded word ids: one pass,
// one hash lookup per word.  Returns tokens written, or -1 when
// `cap` is too small.
int64_t wc_tokenize(WordTokenizer* p, const char* buf, int64_t len,
                    int32_t* ids, int64_t cap) {
  int64_t n = 0;
  const char* cur = buf;
  const char* end = buf + len;
  while (cur < end) {
    while (cur < end && p->stop[static_cast<unsigned char>(*cur)]) ++cur;
    if (cur >= end) break;
    const char* start = cur;
    while (cur < end && !p->stop[static_cast<unsigned char>(*cur)]) ++cur;
    if (n >= cap) return -1;
    ids[n++] = p->vocab.intern(start, cur - start);
  }
  return n;
}

// Find the last newline in [buf, buf+len); returns the index one past
// it (the safe chunk split point), or 0 if none.
int64_t last_line_end(const char* buf, int64_t len) {
  for (int64_t i = len - 1; i >= 0; --i) {
    if (buf[i] == '\n') return i + 1;
  }
  return 0;
}

// Parse "station;temp\n" rows from buf (which must end on a line
// boundary) into dictionary-encoded columns.  Temperatures have
// exactly one decimal (1BRC format) and are emitted as int16
// deci-degrees.  Returns rows written, or -1 on malformed input.
int64_t brc_parse_chunk(BrcParser* p, const char* buf, int64_t len,
                        int32_t* ids, int16_t* temps, int64_t cap) {
  int64_t rows = 0;
  const char* cur = buf;
  const char* end = buf + len;
  while (cur < end && rows < cap) {
    const char* semi =
        static_cast<const char*>(memchr(cur, ';', end - cur));
    if (semi == nullptr) break;
    const char* nl =
        static_cast<const char*>(memchr(semi + 1, '\n', end - (semi + 1)));
    if (nl == nullptr) nl = end;

    // Station id: one hash lookup per row; insert on first sight.
    int32_t id = p->vocab.intern(cur, semi - cur);

    // Temperature: [-]d{1,2}.d → deci-degrees, branch-light parse.
    const char* t = semi + 1;
    bool neg = false;
    if (t < nl && *t == '-') {
      neg = true;
      ++t;
    }
    int32_t v = 0;
    bool ok = false;
    while (t < nl) {
      char c = *t;
      if (c >= '0' && c <= '9') {
        v = v * 10 + (c - '0');
        ok = true;
      } else if (c != '.') {
        return -1;
      }
      ++t;
    }
    if (!ok) return -1;
    temps[rows] = static_cast<int16_t>(neg ? -v : v);
    ids[rows] = id;
    ++rows;
    cur = nl + 1;
  }
  return rows;
}

// Generic newline splitter: writes the byte offsets of line starts
// into `offsets` (up to cap); returns the count.  Used by the
// columnar file feeder to slice micro-batches without Python loops.
int64_t line_offsets(const char* buf, int64_t len, int64_t* offsets,
                     int64_t cap) {
  int64_t n = 0;
  const char* cur = buf;
  const char* end = buf + len;
  while (cur < end && n < cap) {
    offsets[n++] = cur - buf;
    const char* nl = static_cast<const char*>(memchr(cur, '\n', end - cur));
    if (nl == nullptr) break;
    cur = nl + 1;
  }
  return n;
}

}  // extern "C"
