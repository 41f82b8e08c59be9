// Native host components for avxwindowfmindex_tpu.
//
// awfm_suffix_array: 64-bit SA-IS suffix sorting — the from-scratch
// replacement for the reference's libdivsufsort dependency (called at
// AwFmCreate.c:99-100). Induced sorting (Nong, Zhang & Chan 2009),
// O(n) time, recursing on the reduced LMS-substring problem.
//
// Exposed with C linkage for ctypes binding (see ../hostlib.py).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

using idx_t = int64_t;

void get_buckets(const std::vector<idx_t>& counts, std::vector<idx_t>& bkt,
                 idx_t K, bool end) {
  idx_t sum = 0;
  for (idx_t i = 0; i < K; i++) {
    sum += counts[i];
    bkt[i] = end ? sum : sum - counts[i];
  }
}

template <typename CharT>
void get_counts(const CharT* s, std::vector<idx_t>& counts, idx_t n, idx_t K) {
  counts.assign(K, 0);
  for (idx_t i = 0; i < n; i++) counts[s[i]]++;
}

// Induce L-type then S-type suffixes from the placed LMS/sorted entries.
template <typename CharT>
void induce(const CharT* s, idx_t* sa, const std::vector<bool>& stype,
            const std::vector<idx_t>& counts, std::vector<idx_t>& bkt,
            idx_t n, idx_t K) {
  get_buckets(counts, bkt, K, false);
  for (idx_t i = 0; i < n; i++) {
    idx_t j = sa[i] - 1;
    if (sa[i] > 0 && !stype[j]) sa[bkt[s[j]]++] = j;
  }
  get_buckets(counts, bkt, K, true);
  for (idx_t i = n - 1; i >= 0; i--) {
    idx_t j = sa[i] - 1;
    if (sa[i] > 0 && stype[j]) sa[--bkt[s[j]]] = j;
  }
}

// SA-IS over s[0..n): requires s[n-1] == 0, unique and smallest.
template <typename CharT>
void sais(const CharT* s, idx_t* sa, idx_t n, idx_t K) {
  std::vector<bool> stype(n);
  stype[n - 1] = true;
  for (idx_t i = n - 2; i >= 0; i--)
    stype[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && stype[i + 1]);
  auto is_lms = [&](idx_t i) { return i > 0 && stype[i] && !stype[i - 1]; };

  std::vector<idx_t> counts, bkt(K);
  get_counts(s, counts, n, K);

  // stage 1: place LMS suffixes at their bucket ends, then induce.
  get_buckets(counts, bkt, K, true);
  std::fill(sa, sa + n, idx_t(-1));
  for (idx_t i = 1; i < n; i++)
    if (is_lms(i)) sa[--bkt[s[i]]] = i;
  induce(s, sa, stype, counts, bkt, n, K);

  // compact the now-sorted LMS suffixes to the front.
  idx_t n1 = 0;
  for (idx_t i = 0; i < n; i++)
    if (sa[i] > 0 && is_lms(sa[i])) sa[n1++] = sa[i];

  // name LMS substrings; equal substrings share a name.
  std::fill(sa + n1, sa + n, idx_t(-1));
  idx_t name = 0, prev = -1;
  for (idx_t i = 0; i < n1; i++) {
    idx_t pos = sa[i];
    bool diff = false;
    for (idx_t d = 0; d < n; d++) {
      if (prev < 0 || s[pos + d] != s[prev + d] ||
          stype[pos + d] != stype[prev + d]) {
        diff = true;
        break;
      }
      if (d > 0 && (is_lms(pos + d) || is_lms(prev + d))) break;
    }
    if (diff) {
      name++;
      prev = pos;
    }
    sa[n1 + pos / 2] = name - 1;
  }
  for (idx_t i = n - 1, j = n - 1; i >= n1; i--)
    if (sa[i] >= 0) sa[j--] = sa[i];

  // recurse if names are not yet unique.
  idx_t* sa1 = sa;
  idx_t* s1 = sa + n - n1;
  if (name < n1) {
    sais<idx_t>(s1, sa1, n1, name);
  } else {
    for (idx_t i = 0; i < n1; i++) sa1[s1[i]] = i;
  }

  // map the reduced SA back to LMS positions.
  for (idx_t i = 1, j = 0; i < n; i++)
    if (is_lms(i)) s1[j++] = i;
  for (idx_t i = 0; i < n1; i++) sa1[i] = s1[sa1[i]];

  // stage 3: place sorted LMS suffixes, induce the rest.
  get_buckets(counts, bkt, K, true);
  std::fill(sa + n1, sa + n, idx_t(-1));
  for (idx_t i = n1 - 1; i >= 0; i--) {
    idx_t j = sa[i];
    sa[i] = -1;
    sa[--bkt[s[j]]] = j;
  }
  induce(s, sa, stype, counts, bkt, n, K);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// FASTA parsing (FastaVector equivalent: concatenated sequence buffer +
// concatenated header text + cumulative end offsets per record).
// Buffers are malloc'd here; the caller frees them with awfm_free.
// ---------------------------------------------------------------------------

void awfm_free(void* p) { free(p); }

int awfm_read_fasta(const char* path, uint8_t** seq_out, int64_t* seq_len,
                    uint8_t** headers_out, int64_t* headers_len,
                    int64_t** header_ends_out, int64_t** seq_ends_out,
                    int64_t* num_seqs) {
  FILE* fh = fopen(path, "rb");
  if (!fh) return -1;
  // Slurp the whole file and scan for newlines: robust to NUL bytes in
  // lines (fgets/strlen would truncate and desynchronize the parse).
  std::vector<uint8_t> data;
  {
    if (fseek(fh, 0, SEEK_END) != 0) {
      fclose(fh);
      return -1;
    }
    long size = ftell(fh);
    if (size < 0) {
      fclose(fh);
      return -1;
    }
    rewind(fh);
    data.resize((size_t)size);
    if (size > 0 && fread(data.data(), 1, (size_t)size, fh) != (size_t)size) {
      fclose(fh);
      return -1;
    }
  }
  fclose(fh);

  std::vector<uint8_t> seq, headers;
  std::vector<int64_t> header_ends, seq_ends;
  seq.reserve(data.size());
  bool started = false;
  int64_t current_len = 0;

  size_t pos = 0;
  while (pos < data.size()) {
    size_t eol = pos;
    while (eol < data.size() && data[eol] != '\n') eol++;
    size_t line_end = eol;
    while (line_end > pos && data[line_end - 1] == '\r') line_end--;
    const uint8_t* line = data.data() + pos;
    size_t len = line_end - pos;
    if (len > 0 && line[0] == '>') {
      if (started) seq_ends.push_back(current_len);
      started = true;
      current_len = 0;
      headers.insert(headers.end(), line + 1, line + len);
      header_ends.push_back((int64_t)headers.size());
    } else if (len > 0) {
      if (!started) {  // data before any header: one unnamed record
        started = true;
        header_ends.push_back((int64_t)headers.size());
      }
      for (size_t i = 0; i < len; i++) {
        uint8_t c = line[i];
        // '\r' included: stray mid-line CRs must not enter the sequence
        // (kept in lock-step with io/fasta.py read_fasta_python)
        if (c != ' ' && c != '\t' && c != '\v' && c != '\f' && c != '\r') {
          seq.push_back(c);
          current_len++;
        }
      }
    }
    pos = eol + 1;
  }
  if (started) seq_ends.push_back(current_len);
  // cumulative sequence ends
  int64_t acc = 0;
  for (auto& v : seq_ends) {
    acc += v;
    v = acc;
  }

  auto dup = [](const void* src, size_t bytes) -> void* {
    void* p = malloc(bytes ? bytes : 1);
    if (p && bytes) memcpy(p, src, bytes);
    return p;
  };
  *seq_out = (uint8_t*)dup(seq.data(), seq.size());
  *seq_len = (int64_t)seq.size();
  *headers_out = (uint8_t*)dup(headers.data(), headers.size());
  *headers_len = (int64_t)headers.size();
  *header_ends_out = (int64_t*)dup(header_ends.data(),
                                   header_ends.size() * sizeof(int64_t));
  *seq_ends_out =
      (int64_t*)dup(seq_ends.data(), seq_ends.size() * sizeof(int64_t));
  *num_seqs = (int64_t)seq_ends.size();
  if (!*seq_out || !*headers_out || !*header_ends_out || !*seq_ends_out) {
    // free whatever succeeded so a failed parse leaks nothing
    free(*seq_out);
    free(*headers_out);
    free(*header_ends_out);
    free(*seq_ends_out);
    *seq_out = nullptr;
    *headers_out = nullptr;
    *header_ends_out = nullptr;
    *seq_ends_out = nullptr;
    return -2;
  }
  return 0;
}

// Suffix array of `sequence[0..n)` by raw byte order (divsufsort64 call
// parity). Returns 0 on success.
int awfm_suffix_array(const uint8_t* sequence, int64_t* sa_out, int64_t n) {
  if (n <= 0) return -1;
  if (n == 1) {
    sa_out[0] = 0;
    return 0;
  }
  bool has_zero = false;
  for (idx_t i = 0; i < n; i++)
    if (sequence[i] == 0) {
      has_zero = true;
      break;
    }

  std::vector<idx_t> sa_full(n + 1);
  if (!has_zero) {
    // append a 0 sentinel (input is zero-free: sanitized sequences are)
    std::vector<uint8_t> s(n + 1);
    std::memcpy(s.data(), sequence, n);
    s[n] = 0;
    sais<uint8_t>(s.data(), sa_full.data(), n + 1, 256);
  } else {
    // general input: shift bytes by +1 so 0 is free for the sentinel
    std::vector<uint16_t> s(n + 1);
    for (idx_t i = 0; i < n; i++) s[i] = uint16_t(sequence[i]) + 1;
    s[n] = 0;
    sais<uint16_t>(s.data(), sa_full.data(), n + 1, 257);
  }
  // sa_full[0] is the appended sentinel; drop it.
  std::memcpy(sa_out, sa_full.data() + 1, n * sizeof(int64_t));
  return 0;
}
}
