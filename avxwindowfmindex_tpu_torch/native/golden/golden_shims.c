/* Implementations for the golden-parity shims (FastaVector.h,
 * divsufsort64.h in this directory). Compiled together with the
 * read-only reference sources into the golden driver binary; see
 * tools/golden_parity.py for the build recipe and
 * tests/test_golden_reference.py for the byte-parity assertions.
 *
 * The FASTA parse reproduces native/src/awfm_host.cpp awfm_read_fasta
 * line for line in spirit: slurp whole file, split on '\n', strip
 * trailing '\r', '>' lines start a record (header stored without '>'),
 * blank-insensitive sequence lines with spaces/tabs removed, data
 * before any header forms one unnamed record.
 */
#include "FastaVector.h"
#include "divsufsort64.h"

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* from native/src/awfm_host.cpp (linked as C++ object) */
extern int awfm_suffix_array(const uint8_t *sequence, int64_t *sa_out,
                             int64_t n);

int64_t divsufsort64(const uint8_t *T, int64_t *SA, int64_t n) {
  return awfm_suffix_array(T, SA, n) == 0 ? 0 : -1;
}

enum FastaVectorReturnCode fastaVectorInit(struct FastaVector *v) {
  memset(v, 0, sizeof(*v));
  /* reference relies on ">= count+1 capacity" for the sentinel poke
   * (AwFmCreate.c:193-196); start all buffers 1-byte allocated */
  v->sequence.charData = malloc(1);
  v->header.charData = malloc(1);
  v->metadata.data = malloc(sizeof(struct FastaVectorMetadata));
  if (!v->sequence.charData || !v->header.charData || !v->metadata.data) {
    return FASTA_VECTOR_ALLOCATION_FAIL;
  }
  v->sequence.capacity = 1;
  v->header.capacity = 1;
  v->metadata.capacity = 1;
  return FASTA_VECTOR_OK;
}

void fastaVectorStringDealloc(struct FastaVectorString *s) {
  free(s->charData);
  s->charData = NULL;
  s->count = 0;
  s->capacity = 0;
}

void fastaVectorDealloc(struct FastaVector *v) {
  fastaVectorStringDealloc(&v->sequence);
  fastaVectorStringDealloc(&v->header);
  free(v->metadata.data);
  v->metadata.data = NULL;
  v->metadata.count = 0;
  v->metadata.capacity = 0;
}

static bool stringPush(struct FastaVectorString *s, const char *bytes,
                       size_t len) {
  if (s->count + len + 1 > s->capacity) {
    size_t cap = s->capacity ? s->capacity : 16;
    while (cap < s->count + len + 1) {
      cap *= 2;
    }
    char *p = realloc(s->charData, cap);
    if (!p) {
      return false;
    }
    s->charData = p;
    s->capacity = cap;
  }
  memcpy(s->charData + s->count, bytes, len);
  s->count += len;
  return true;
}

static bool metadataPush(struct FastaVectorMetadataVector *m,
                         struct FastaVectorMetadata entry) {
  if (m->count + 1 > m->capacity) {
    size_t cap = m->capacity ? m->capacity * 2 : 16;
    struct FastaVectorMetadata *p =
        realloc(m->data, cap * sizeof(struct FastaVectorMetadata));
    if (!p) {
      return false;
    }
    m->data = p;
    m->capacity = cap;
  }
  m->data[m->count++] = entry;
  return true;
}

enum FastaVectorReturnCode fastaVectorReadFasta(const char *fileSrc,
                                                struct FastaVector *v) {
  FILE *fh = fopen(fileSrc, "rb");
  if (!fh) {
    return FASTA_VECTOR_FILE_OPEN_FAIL;
  }
  if (fseek(fh, 0, SEEK_END) != 0) {
    fclose(fh);
    return FASTA_VECTOR_FILE_READ_FAIL;
  }
  long size = ftell(fh);
  if (size < 0) {
    fclose(fh);
    return FASTA_VECTOR_FILE_READ_FAIL;
  }
  rewind(fh);
  char *data = malloc(size ? (size_t)size : 1);
  if (!data) {
    fclose(fh);
    return FASTA_VECTOR_ALLOCATION_FAIL;
  }
  if (size > 0 && fread(data, 1, (size_t)size, fh) != (size_t)size) {
    free(data);
    fclose(fh);
    return FASTA_VECTOR_FILE_READ_FAIL;
  }
  fclose(fh);

  bool started = false;
  bool ok = true;
  size_t pos = 0;
  while (ok && pos < (size_t)size) {
    size_t eol = pos;
    while (eol < (size_t)size && data[eol] != '\n') {
      eol++;
    }
    size_t lineEnd = eol;
    while (lineEnd > pos && data[lineEnd - 1] == '\r') {
      lineEnd--;
    }
    const char *line = data + pos;
    size_t len = lineEnd - pos;
    if (len > 0 && line[0] == '>') {
      if (started) { /* patch the previous record's sequence end */
        v->metadata.data[v->metadata.count - 1].sequenceEndPosition =
            v->sequence.count;
      }
      started = true;
      ok = stringPush(&v->header, line + 1, len - 1);
      struct FastaVectorMetadata entry = {v->header.count, v->sequence.count};
      ok = ok && metadataPush(&v->metadata, entry);
    } else if (len > 0) {
      if (!started) { /* data before any header: one unnamed record */
        started = true;
        struct FastaVectorMetadata entry = {v->header.count,
                                            v->sequence.count};
        ok = metadataPush(&v->metadata, entry);
      }
      for (size_t i = 0; ok && i < len; i++) {
        char c = line[i];
        /* '\r' filtered like the product parsers (io/fasta.py,
         * native/src/awfm_host.cpp): a stray mid-line CR must not
         * enter the sequence. Upstream FastaVector is unavailable in
         * the snapshot; all three parsers keep this reconstructed
         * convention in lock-step. */
        if (c != ' ' && c != '\t' && c != '\v' && c != '\f' && c != '\r') {
          ok = stringPush(&v->sequence, &c, 1);
        }
      }
    }
    pos = eol + 1;
  }
  if (started && ok) {
    v->metadata.data[v->metadata.count - 1].sequenceEndPosition =
        v->sequence.count;
  }
  free(data);
  if (!ok) {
    return FASTA_VECTOR_ALLOCATION_FAIL;
  }
  if (v->sequence.charData) { /* NUL-terminate (capacity reserved above) */
    v->sequence.charData[v->sequence.count] = '\0';
  }
  return FASTA_VECTOR_OK;
}

void fastaVectorGetHeader(struct FastaVector *v, size_t sequenceIndex,
                          char **headerPtr, size_t *headerLength) {
  if (sequenceIndex >= v->metadata.count) {
    *headerPtr = NULL;
    *headerLength = 0;
    return;
  }
  size_t start =
      sequenceIndex == 0
          ? 0
          : (size_t)v->metadata.data[sequenceIndex - 1].headerEndPosition;
  size_t end = (size_t)v->metadata.data[sequenceIndex].headerEndPosition;
  *headerPtr = v->header.charData + start;
  *headerLength = end - start;
}

bool fastaVectorGetLocalSequencePositionFromGlobal(
    const struct FastaVector *v, size_t globalPosition,
    struct FastaVectorLocalPosition *out) {
  size_t n = v->metadata.count;
  if (n == 0 ||
      globalPosition >= (size_t)v->metadata.data[n - 1].sequenceEndPosition) {
    return false;
  }
  /* binary search over cumulative exclusive ends (side='right') */
  size_t lo = 0, hi = n;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (globalPosition < (size_t)v->metadata.data[mid].sequenceEndPosition) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  size_t start =
      lo == 0 ? 0 : (size_t)v->metadata.data[lo - 1].sequenceEndPosition;
  out->sequenceIndex = lo;
  out->positionInSequence = globalPosition - start;
  return true;
}
