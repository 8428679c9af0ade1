// First-party C++ byte-level BPE core (tiktoken contract).
//
// Replaces the reference's native tiktoken Rust BPE (SURVEY.md §2.3; the
// tokenization contract is bit-identical DSU/text token streams — ref:
// ssi/tokenizer/monkeypatch.py:7) with hand-written scanners for two split
// regexes plus the standard greedy lowest-rank pair merge. Each regex is
// implemented as a direct decision procedure — the pattern's alternatives
// tried in order at each position, exactly the leftmost-alternation semantics
// of tiktoken's regex engine. CL100K_PATTERN_PUA (mode kPua):
//
//   1. (?i:'s|'t|'re|'ve|'m|'ll|'d)           contractions (simple case fold)
//   2. [^\r\n\p{L}\p{N}\p{Co}]?\p{L}+          optional prefix + letter run
//   3. \p{N}{1,3}                              1-3 digits
//   4.  ?[^\s\p{L}\p{N}\p{Co}]+[\r\n]*         optional space + punct + newlines
//   5. \s*[\r\n]+                              whitespace ending in newlines
//   6. \s+(?!\S)                               trailing whitespace (leave last)
//   7. \s+                                     whitespace
//   8. \p{Co}                                  single private-use codepoint
//
// CL100K_PATTERN (mode kCl100k, the BPE-compressed DSU runs) is the same
// procedure without the \p{Co} exclusions of 2 and 4 and without 8: a
// private-use codepoint may prefix a letter run, and runs of DSU characters
// and punctuation fuse into one piece (so a DSU span is one piece and the
// trained multi-DSU merges can fire). Mode kWhole takes the whole text as
// one piece, tiktoken's (?s:.+).
//
// Character classes come from generated Unicode tables (unicode_tables.h);
// equivalence with tiktoken is enforced by differential fuzzing
// (tests/test_native_bpe.py, tests/test_torch_cl100k.py), including the
// U+017F (long s) case-fold edge of alternative 1 and the PUA planes.
//
// Special tokens are deliberately NOT handled here: the tokenizer encodes
// user text with specials disabled (ssi_tpu/tokenizer/__init__.py:176), and
// the Python wrapper splices special IDs around the native calls.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

#include "unicode_tables.h"

namespace {

thread_local std::string g_bpe_error;

// ---------------------------------------------------------------------------
// Character classification
// ---------------------------------------------------------------------------

bool in_ranges(uint32_t cp, const uni::CpRange* ranges, size_t n) {
  size_t lo = 0, hi = n;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (cp < ranges[mid].lo) {
      hi = mid;
    } else if (cp > ranges[mid].hi) {
      lo = mid + 1;
    } else {
      return true;
    }
  }
  return false;
}

bool is_letter(uint32_t cp) { return in_ranges(cp, uni::kLetter, uni::kLetter_len); }
bool is_number(uint32_t cp) { return in_ranges(cp, uni::kNumber, uni::kNumber_len); }
bool is_space(uint32_t cp) { return in_ranges(cp, uni::kWhitespace, uni::kWhitespace_len); }

bool is_private_use(uint32_t cp) {
  return (cp >= 0xE000 && cp <= 0xF8FF) || (cp >= 0xF0000 && cp <= 0xFFFFD) ||
         (cp >= 0x100000 && cp <= 0x10FFFD);
}

bool is_newline(uint32_t cp) { return cp == '\r' || cp == '\n'; }

// Simple case-fold membership for the contraction letters. U+017F (LATIN SMALL
// LETTER LONG S) folds to 's' under Unicode simple folding, so (?i:'s) matches
// the two-codepoint string "'ſ" — tiktoken's engine does this too.
bool folds_to(uint32_t cp, char target) {
  if (cp == static_cast<uint32_t>(target)) return true;
  if (cp == static_cast<uint32_t>(target - 'a' + 'A')) return true;
  if (target == 's' && cp == 0x017F) return true;
  return false;
}

// ---------------------------------------------------------------------------
// UTF-8 iteration (input is valid UTF-8 — produced by Python str.encode)
// ---------------------------------------------------------------------------

struct Cp {
  uint32_t cp;
  uint32_t len;  // bytes
};

Cp decode_utf8(const uint8_t* p, const uint8_t* end) {
  uint8_t b = p[0];
  if (b < 0x80) return {b, 1};
  if ((b >> 5) == 0x6 && p + 1 < end) return {((b & 0x1Fu) << 6) | (p[1] & 0x3Fu), 2};
  if ((b >> 4) == 0xE && p + 2 < end)
    return {((b & 0x0Fu) << 12) | ((p[1] & 0x3Fu) << 6) | (p[2] & 0x3Fu), 3};
  if ((b >> 3) == 0x1E && p + 3 < end)
    return {((b & 0x07u) << 18) | ((p[1] & 0x3Fu) << 12) | ((p[2] & 0x3Fu) << 6) | (p[3] & 0x3Fu), 4};
  return {0xFFFD, 1};  // unreachable on valid input
}

// Decoded view of a text: codepoints plus the byte offset of each (and the end).
struct Decoded {
  std::vector<uint32_t> cps;
  std::vector<size_t> byte_off;  // size cps.size() + 1

  explicit Decoded(const uint8_t* data, size_t len) {
    cps.reserve(len);
    byte_off.reserve(len + 1);
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    while (p < end) {
      byte_off.push_back(static_cast<size_t>(p - data));
      Cp c = decode_utf8(p, end);
      cps.push_back(c.cp);
      p += c.len;
    }
    byte_off.push_back(len);
  }
};

// ---------------------------------------------------------------------------
// The split scanner: returns the match length IN CODEPOINTS at position i,
// trying the pattern's alternatives in order (0 = no match, impossible in
// practice — every codepoint class is covered). `pua` selects
// CL100K_PATTERN_PUA, else CL100K_PATTERN.
// ---------------------------------------------------------------------------

// The split modes of bpe_encode and bpe_split.
enum Mode : int32_t { kPua = 0, kCl100k = 1, kWhole = 2 };

size_t match_at(const std::vector<uint32_t>& s, size_t i, bool pua) {
  const size_t n = s.size();
  const uint32_t c0 = s[i];
  // the \p{Co} exclusions of alternatives 2 and 4 (PUA pattern only)
  auto excluded = [pua](uint32_t cp) { return pua && is_private_use(cp); };

  // 1. (?i:'s|'t|'re|'ve|'m|'ll|'d)
  if (c0 == '\'' && i + 1 < n) {
    const uint32_t c1 = s[i + 1];
    // order matters only between prefixes; these alternatives are prefix-free
    // except 's/'t/'m/'d vs the two-letter ones starting with different letters
    if (folds_to(c1, 's') || folds_to(c1, 't') || folds_to(c1, 'm') || folds_to(c1, 'd')) return 2;
    if (i + 2 < n) {
      const uint32_t c2 = s[i + 2];
      if (folds_to(c1, 'r') && folds_to(c2, 'e')) return 3;
      if (folds_to(c1, 'v') && folds_to(c2, 'e')) return 3;
      if (folds_to(c1, 'l') && folds_to(c2, 'l')) return 3;
    }
  }

  // 2. [^\r\n\p{L}\p{N}\p{Co}]?\p{L}+  (cl100k: [^\r\n\p{L}\p{N}]?\p{L}+)
  {
    size_t j = i;
    if (!is_letter(c0) && !is_newline(c0) && !is_number(c0) && !excluded(c0)) j = i + 1;
    if (j < n && is_letter(s[j])) {
      size_t k = j;
      while (k < n && is_letter(s[k])) ++k;
      return k - i;
    }
  }

  // 3. \p{N}{1,3}
  if (is_number(c0)) {
    size_t k = i;
    while (k < n && k < i + 3 && is_number(s[k])) ++k;
    return k - i;
  }

  // 4.  ?[^\s\p{L}\p{N}\p{Co}]+[\r\n]*  (cl100k:  ?[^\s\p{L}\p{N}]+[\r\n]*)
  {
    size_t j = i;
    if (c0 == ' ') j = i + 1;
    auto is_punct = [&excluded](uint32_t cp) {
      return !is_space(cp) && !is_letter(cp) && !is_number(cp) && !excluded(cp);
    };
    if (j < n && is_punct(s[j])) {
      size_t k = j;
      while (k < n && is_punct(s[k])) ++k;
      while (k < n && is_newline(s[k])) ++k;
      return k - i;
    }
  }

  // Alternatives 5-7 all start with whitespace.
  if (is_space(c0)) {
    size_t k = i;
    size_t last_nl = SIZE_MAX;
    while (k < n && is_space(s[k])) {
      if (is_newline(s[k])) last_nl = k;
      ++k;
    }
    const size_t w = k - i;
    // 5. \s*[\r\n]+ — match up to (and including) the last newline in the run
    if (last_nl != SIZE_MAX) return last_nl - i + 1;
    // 6. \s+(?!\S) — at end of input take all; else leave the last whitespace
    //    codepoint for the next match (it will glue to a following word)
    if (k == n) return w;
    if (w >= 2) return w - 1;
    // 7. \s+
    return w;
  }

  // 8. \p{Co} (PUA pattern only; cl100k matched it in 2 or 4)
  if (pua && is_private_use(c0)) return 1;

  return 0;
}

// Calls f(byte_start, byte_end) for each piece of the text under `mode`.
template <class F>
void for_each_piece(const uint8_t* data, size_t len, int32_t mode, F f) {
  if (mode == kWhole) {
    if (len > 0) f(size_t{0}, len);
    return;
  }
  Decoded d(data, len);
  size_t i = 0;
  const size_t n = d.cps.size();
  while (i < n) {
    size_t m = match_at(d.cps, i, mode == kPua);
    if (m == 0) {  // defensive: skip an unmatchable codepoint (none exist)
      ++i;
      continue;
    }
    f(d.byte_off[i], d.byte_off[i + m]);
    i += m;
  }
}

// ---------------------------------------------------------------------------
// Greedy lowest-rank pair merge (the BPE core)
// ---------------------------------------------------------------------------

constexpr uint32_t RANK_MAX = UINT32_MAX;

struct Bpe {
  std::unordered_map<std::string, uint32_t> ranks;
  std::vector<std::string> tokens;  // rank -> bytes

  uint32_t lookup(const uint8_t* data, size_t a, size_t b) const {
    std::string key(reinterpret_cast<const char*>(data) + a, b - a);
    auto it = ranks.find(key);
    return it == ranks.end() ? RANK_MAX : it->second;
  }

  // Encode one regex piece.
  void encode_piece(const uint8_t* data, size_t len, std::vector<int32_t>& out) const {
    if (len == 1) {
      out.push_back(static_cast<int32_t>(lookup(data, 0, 1)));
      return;
    }
    {
      std::string whole(reinterpret_cast<const char*>(data), len);
      auto it = ranks.find(whole);
      if (it != ranks.end()) {
        out.push_back(static_cast<int32_t>(it->second));
        return;
      }
    }
    // parts[i] = (byte start, rank of merging parts i and i+1)
    std::vector<std::pair<size_t, uint32_t>> parts;
    parts.reserve(len + 1);
    for (size_t k = 0; k < len; ++k) {
      uint32_t r = (k + 2 <= len) ? lookup(data, k, k + 2) : RANK_MAX;
      parts.emplace_back(k, r);
    }
    parts.emplace_back(len, RANK_MAX);

    auto pair_rank = [&](size_t idx) -> uint32_t {
      // rank of merging parts[idx] with parts[idx+1] (bytes [start_idx, start_idx+2))
      if (idx + 2 >= parts.size()) return RANK_MAX;
      return lookup(data, parts[idx].first, parts[idx + 2].first);
    };

    while (parts.size() > 2) {
      uint32_t best = RANK_MAX;
      size_t best_i = 0;
      for (size_t k = 0; k + 1 < parts.size(); ++k) {
        if (parts[k].second < best) {
          best = parts[k].second;
          best_i = k;
        }
      }
      if (best == RANK_MAX) break;
      parts.erase(parts.begin() + static_cast<ptrdiff_t>(best_i) + 1);
      parts[best_i].second = pair_rank(best_i);
      if (best_i > 0) parts[best_i - 1].second = pair_rank(best_i - 1);
    }
    for (size_t k = 0; k + 1 < parts.size(); ++k) {
      uint32_t r = lookup(data, parts[k].first, parts[k + 1].first);
      out.push_back(static_cast<int32_t>(r));
    }
  }

  void encode(const uint8_t* data, size_t len, int32_t mode, std::vector<int32_t>& out) const {
    for_each_piece(data, len, mode, [&](size_t a, size_t b) { encode_piece(data + a, b - a, out); });
  }
};

// ---------------------------------------------------------------------------
// tokenizer.model loader: "<base64 token> <decimal rank>\n" per line
// ---------------------------------------------------------------------------

int b64_val(char c) {
  if (c >= 'A' && c <= 'Z') return c - 'A';
  if (c >= 'a' && c <= 'z') return c - 'a' + 26;
  if (c >= '0' && c <= '9') return c - '0' + 52;
  if (c == '+') return 62;
  if (c == '/') return 63;
  return -1;
}

bool b64_decode(const char* s, size_t len, std::string& out) {
  out.clear();
  uint32_t acc = 0;
  int bits = 0;
  for (size_t i = 0; i < len; ++i) {
    if (s[i] == '=') break;
    int v = b64_val(s[i]);
    if (v < 0) return false;
    acc = (acc << 6) | static_cast<uint32_t>(v);
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      out += static_cast<char>((acc >> bits) & 0xFF);
    }
  }
  return true;
}

// Parses a merges file's bytes; nullptr (and g_bpe_error) on a malformed file.
Bpe* parse_ranks(const char* data, size_t len) {
  auto bpe = std::make_unique<Bpe>();
  int64_t max_rank = -1;
  size_t pos = 0;
  while (pos < len) {
    const char* nl = static_cast<const char*>(memchr(data + pos, '\n', len - pos));
    size_t end = nl ? static_cast<size_t>(nl - data) : len;
    std::string line(data + pos, end - pos);
    pos = end + 1;
    while (!line.empty() && (line.back() == '\n' || line.back() == '\r')) line.pop_back();
    if (line.empty()) continue;
    size_t sp = line.rfind(' ');
    if (sp == std::string::npos) {
      g_bpe_error = "malformed merges line (no rank): " + line.substr(0, 40);
      return nullptr;
    }
    std::string tok;
    if (!b64_decode(line.data(), sp, tok)) {
      g_bpe_error = "malformed base64 token: " + line.substr(0, 40);
      return nullptr;
    }
    long rank = strtol(line.c_str() + sp + 1, nullptr, 10);
    if (rank < 0) {
      g_bpe_error = "negative rank in merges file";
      return nullptr;
    }
    if (!bpe->ranks.emplace(std::move(tok), static_cast<uint32_t>(rank)).second) {
      g_bpe_error = "duplicate token in merges file: " + line.substr(0, 40);
      return nullptr;
    }
    if (rank > max_rank) max_rank = rank;
  }
  if (bpe->ranks.empty()) {
    g_bpe_error = "empty merges file";
    return nullptr;
  }
  // Strict structural validation: a silent gap or duplicate here would later
  // surface as token id -1 from encode (RANK_MAX truncated) or "" from decode.
  if (static_cast<size_t>(max_rank) + 1 != bpe->ranks.size()) {
    g_bpe_error = "non-contiguous or duplicate ranks: max rank " + std::to_string(max_rank) +
                  " but " + std::to_string(bpe->ranks.size()) + " entries";
    return nullptr;
  }
  bpe->tokens.resize(static_cast<size_t>(max_rank) + 1);
  for (const auto& [tok, rank] : bpe->ranks) bpe->tokens[rank] = tok;
  // Every single byte must be encodable or encode_piece emits RANK_MAX -> -1.
  for (int b = 0; b < 256; ++b) {
    std::string key(1, static_cast<char>(b));
    if (bpe->ranks.find(key) == bpe->ranks.end()) {
      g_bpe_error = "incomplete byte alphabet: single byte " + std::to_string(b) +
                    " has no token (not a byte-level BPE vocab?)";
      return nullptr;
    }
  }
  return bpe.release();
}

}  // namespace

extern "C" {

const char* bpe_last_error() { return g_bpe_error.c_str(); }

void* bpe_new(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    g_bpe_error = std::string("cannot open ") + path;
    return nullptr;
  }
  std::string data;
  char buf[1 << 16];
  size_t got;
  while ((got = fread(buf, 1, sizeof(buf), f)) > 0) data.append(buf, got);
  fclose(f);
  return parse_ranks(data.data(), data.size());
}

// The same from a merges file's bytes in memory.
void* bpe_new_from_buffer(const char* data, int64_t len) {
  return parse_ranks(data, static_cast<size_t>(len));
}

void bpe_free(void* handle) { delete static_cast<Bpe*>(handle); }

int64_t bpe_n_vocab(void* handle) {
  return static_cast<int64_t>(static_cast<Bpe*>(handle)->tokens.size());
}

// Encodes UTF-8 text, split under `mode` (kPua, kCl100k or kWhole); *out is
// new[]-allocated, freed with bpe_free_i32.
int bpe_encode(void* handle, const uint8_t* text, int64_t len, int32_t mode, int32_t** out, int64_t* out_len) {
  if (mode != kPua && mode != kCl100k && mode != kWhole) {
    g_bpe_error = "unknown split mode " + std::to_string(mode);
    return -1;
  }
  const auto* bpe = static_cast<Bpe*>(handle);
  std::vector<int32_t> ids;
  ids.reserve(static_cast<size_t>(len) / 3 + 8);
  bpe->encode(text, static_cast<size_t>(len), mode, ids);
  *out = new int32_t[ids.size() ? ids.size() : 1];
  std::memcpy(*out, ids.data(), ids.size() * sizeof(int32_t));
  *out_len = static_cast<int64_t>(ids.size());
  return 0;
}

void bpe_free_i32(int32_t* p) { delete[] p; }

// Splits UTF-8 text under `mode`: *ends holds each piece's end byte offset
// (the next piece starts there), new[]-allocated, freed with bpe_free_i64.
int bpe_split(const uint8_t* text, int64_t len, int32_t mode, int64_t** ends, int64_t* n) {
  if (mode != kPua && mode != kCl100k && mode != kWhole) {
    g_bpe_error = "unknown split mode " + std::to_string(mode);
    return -1;
  }
  std::vector<int64_t> out;
  for_each_piece(text, static_cast<size_t>(len), mode,
                 [&](size_t, size_t b) { out.push_back(static_cast<int64_t>(b)); });
  *ends = new int64_t[out.size() ? out.size() : 1];
  std::memcpy(*ends, out.data(), out.size() * sizeof(int64_t));
  *n = static_cast<int64_t>(out.size());
  return 0;
}

void bpe_free_i64(int64_t* p) { delete[] p; }

// Encodes UTF-8 text already cut into pieces by a split regex the scanner does
// not implement (tiktoken's encode under that regex): piece i is the bytes
// [ends[i-1], ends[i]) with ends[-1] = 0, and each is merged alone, as
// bpe_encode merges a scanner's piece. The ends rise and the last is len. *out
// freed with bpe_free_i32.
int bpe_encode_pieces(void* handle, const uint8_t* text, int64_t len, const int64_t* ends, int64_t n,
                      int32_t** out, int64_t* out_len) {
  const auto* bpe = static_cast<Bpe*>(handle);
  std::vector<int32_t> ids;
  ids.reserve(static_cast<size_t>(len) / 3 + 8);
  int64_t start = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (ends[i] <= start || ends[i] > len) {
      g_bpe_error = "piece end " + std::to_string(ends[i]) + " does not rise within the text (" +
                    std::to_string(len) + " bytes)";
      return -1;
    }
    bpe->encode_piece(text + start, static_cast<size_t>(ends[i] - start), ids);
    start = ends[i];
  }
  if (start != len) {
    g_bpe_error = "the pieces end at byte " + std::to_string(start) + " of " + std::to_string(len);
    return -1;
  }
  *out = new int32_t[ids.size() ? ids.size() : 1];
  std::memcpy(*out, ids.data(), ids.size() * sizeof(int32_t));
  *out_len = static_cast<int64_t>(ids.size());
  return 0;
}

// Decodes base-vocab ids to bytes; unknown ids are an error (special ids are
// spliced by the Python wrapper before calling this). *out freed with
// bpe_free_u8.
int bpe_decode(void* handle, const int32_t* ids, int64_t n, uint8_t** out, int64_t* out_len) {
  const auto* bpe = static_cast<Bpe*>(handle);
  std::string buf;
  for (int64_t i = 0; i < n; ++i) {
    if (ids[i] < 0 || static_cast<size_t>(ids[i]) >= bpe->tokens.size()) {
      g_bpe_error = "token id out of range: " + std::to_string(ids[i]);
      return -1;
    }
    buf += bpe->tokens[static_cast<size_t>(ids[i])];
  }
  *out = new uint8_t[buf.size() ? buf.size() : 1];
  std::memcpy(*out, buf.data(), buf.size());
  *out_len = static_cast<int64_t>(buf.size());
  return 0;
}

void bpe_free_u8(uint8_t* p) { delete[] p; }

// Raw token bytes for one id (for wrapper-side vocab introspection).
int bpe_token_bytes(void* handle, int32_t id, const uint8_t** out, int64_t* out_len) {
  const auto* bpe = static_cast<Bpe*>(handle);
  if (id < 0 || static_cast<size_t>(id) >= bpe->tokens.size()) {
    g_bpe_error = "token id out of range: " + std::to_string(id);
    return -1;
  }
  const std::string& t = bpe->tokens[static_cast<size_t>(id)];
  *out = reinterpret_cast<const uint8_t*>(t.data());
  *out_len = static_cast<int64_t>(t.size());
  return 0;
}

}  // extern "C"
