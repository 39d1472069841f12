// Native data layer for libpll2_jax: the host-side pipeline that feeds the
// device — FASTA/PHYLIP scanning, site-pattern compression, and tip bit-mask
// encoding.  The reference implements this layer in C (fasta.c, phylip.c,
// compress.c, pll.c tip encoding); here it is a fresh C++ implementation
// exposed over a plain C ABI for ctypes (no pybind11 in this image).
//
// Semantics contract (validated by tests/test_native.py against the
// pure-numpy implementations in libpll2_jax/io/):
//   * compression produces patterns in ascending lexicographic order of
//     encoded columns (identical to np.unique(cols, axis=0));
//   * FASTA parsing keeps alnum plus "-?*.!", silently strips
//     space/tab/cr/lf/nul/vt/ff, errors on anything else (fasta.c:27-60
//     char-status semantics).
#include <cstdint>
#include <cstring>
#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <algorithm>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Site-pattern compression
// ---------------------------------------------------------------------------
// enc: [count * length] row-major encoded alignment (one byte per state
// code, 0 = illegal).  Outputs:
//   site_pattern_map[length]  original site -> pattern index
//   weights[length]           pattern weights (first n_patterns valid)
//   rep_sites[length]         one representative original site per pattern
// Returns n_patterns, or -1 on error.
int64_t pllt_compress_patterns(const uint8_t* enc, int64_t count,
                               int64_t length, uint32_t* site_pattern_map,
                               uint32_t* weights, uint32_t* rep_sites) {
  if (count <= 0 || length <= 0) return -1;

  // transpose into contiguous columns for cache-friendly comparisons
  std::vector<uint8_t> cols((size_t)count * (size_t)length);
  for (int64_t i = 0; i < count; ++i) {
    const uint8_t* row = enc + i * length;
    for (int64_t j = 0; j < length; ++j)
      cols[(size_t)j * count + i] = row[j];
  }

  std::vector<uint32_t> order(length);
  std::iota(order.begin(), order.end(), 0u);
  const uint8_t* base = cols.data();
  const size_t n = (size_t)count;
  std::sort(order.begin(), order.end(), [base, n](uint32_t a, uint32_t b) {
    int c = std::memcmp(base + (size_t)a * n, base + (size_t)b * n, n);
    if (c != 0) return c < 0;
    return a < b;
  });

  int64_t np = 0;
  for (int64_t k = 0; k < length; ++k) {
    uint32_t site = order[k];
    if (k == 0 || std::memcmp(base + (size_t)site * n,
                              base + (size_t)order[k - 1] * n, n) != 0) {
      rep_sites[np] = site;
      weights[np] = 0;
      ++np;
    }
    site_pattern_map[site] = (uint32_t)(np - 1);
    weights[np - 1] += 1;
  }
  return np;
}

// ---------------------------------------------------------------------------
// Tip encoding: chars -> state bit-masks through a 256-entry map
// ---------------------------------------------------------------------------
// Returns index of first illegal char, or -1 on success.
int64_t pllt_encode_tip(const uint8_t* seq, int64_t length,
                        const uint64_t* map256, uint64_t* out) {
  for (int64_t i = 0; i < length; ++i) {
    uint64_t v = map256[seq[i]];
    if (v == 0) return i;
    out[i] = v;
  }
  return -1;
}

// ---------------------------------------------------------------------------
// FASTA scanning
// ---------------------------------------------------------------------------
// Pass 1: count records and measure buffer sizes.
// Returns 0 on success; fills n_records, total_label_bytes,
// total_seq_bytes.  error_line > 0 flags an illegal character.
static inline bool strip_char(uint8_t c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\0' ||
         c == '\v' || c == '\f';
}

static inline bool legal_char(uint8_t c) {
  return std::isalnum(c) || c == '-' || c == '?' || c == '*' || c == '.' ||
         c == '!';
}

int64_t pllt_fasta_scan(const char* data, int64_t size, int64_t* n_records,
                        int64_t* total_label_bytes, int64_t* total_seq_bytes,
                        int64_t* error_line) {
  int64_t nrec = 0, lab = 0, seq = 0, line = 1;
  *error_line = 0;
  int64_t i = 0;
  bool in_header = false, seen_header = false;
  while (i < size) {
    char c = data[i];
    if (c == '\n') { ++line; in_header = false; ++i; continue; }
    if (!in_header && c == '>' && (i == 0 || data[i - 1] == '\n')) {
      ++nrec;
      seen_header = true;
      in_header = true;
      ++i;
      continue;
    }
    if (in_header) {
      ++lab;
      ++i;
      continue;
    }
    uint8_t u = (uint8_t)c;
    if (strip_char(u)) { ++i; continue; }
    if (!seen_header || !legal_char(u)) { *error_line = line; return -1; }
    ++seq;
    ++i;
  }
  *n_records = nrec;
  *total_label_bytes = lab;
  *total_seq_bytes = seq;
  return 0;
}

// Pass 2: fill flat label/sequence buffers plus per-record START offsets
// (label_off/seq_off have n_records+1 entries; entry n_records = total).
// Labels are whitespace-trimmed at both ends (matching header.strip()).
int64_t pllt_fasta_read(const char* data, int64_t size, char* labels,
                        int64_t* label_off, char* seqs, int64_t* seq_off) {
  int64_t nrec = 0, lab = 0, seq = 0;
  int64_t i = 0;
  bool in_header = false;
  int64_t header_start = -1;
  auto flush_header = [&](int64_t end) {
    int64_t s = header_start, e = end;
    while (s < e && strip_char((uint8_t)data[s])) ++s;
    while (e > s && strip_char((uint8_t)data[e - 1])) --e;
    std::memcpy(labels + lab, data + s, (size_t)(e - s));
    lab += e - s;
  };
  while (i < size) {
    char c = data[i];
    if (c == '\n') {
      if (in_header) { flush_header(i); in_header = false; }
      ++i;
      continue;
    }
    if (!in_header && c == '>' && (i == 0 || data[i - 1] == '\n')) {
      label_off[nrec] = lab;   // start of this record's label
      seq_off[nrec] = seq;     // start of this record's sequence
      ++nrec;
      in_header = true;
      header_start = i + 1;
      ++i;
      continue;
    }
    if (in_header) { ++i; continue; }
    uint8_t u = (uint8_t)c;
    if (!strip_char(u)) { seqs[seq++] = c; }
    ++i;
  }
  if (in_header) flush_header(size);
  label_off[nrec] = lab;
  seq_off[nrec] = seq;
  return nrec;
}

}  // extern "C"
