/* Minimal FastaVector shim — golden-parity build support.
 *
 * The reference (/root/reference) depends on the FastaVector library via
 * an empty git submodule, so it cannot compile as-is. This header
 * reconstructs exactly the surface the reference consumes (struct
 * fields at AwFmCreate.c:162-196, AwFmFile.c:157-187 + 360-440,
 * AwFmSearch.c:284-315) so that the REFERENCE C SOURCES can be built
 * into a golden binary whose .awfmi output and hit lists our TPU
 * implementation is byte-compared against (tests/test_golden_reference.py).
 *
 * Parsing and layout conventions mirror this repo's own FASTA handling
 * (native/src/awfm_host.cpp awfm_read_fasta, models/index.py
 * FastaMetadata): headers stored without '>' or terminators,
 * header/sequence end positions cumulative exclusive u64.
 */
#ifndef FASTA_VECTOR_H
#define FASTA_VECTOR_H

#include <stdbool.h>
#include <stddef.h>
#include <stdint.h>

enum FastaVectorReturnCode {
  FASTA_VECTOR_OK = 0,
  FASTA_VECTOR_FILE_OPEN_FAIL = -1,
  FASTA_VECTOR_FILE_READ_FAIL = -2,
  FASTA_VECTOR_FILE_WRITE_FAIL = -3,
  FASTA_VECTOR_ALLOCATION_FAIL = -4
};

struct FastaVectorString {
  char *charData;
  size_t count;
  size_t capacity;
};

/* Serialized verbatim into .awfmi (AwFmFile.c:181-183): two
 * little-endian u64 cumulative exclusive end offsets per record. */
struct FastaVectorMetadata {
  uint64_t headerEndPosition;
  uint64_t sequenceEndPosition;
};

struct FastaVectorMetadataVector {
  struct FastaVectorMetadata *data;
  size_t count;
  size_t capacity;
};

struct FastaVector {
  struct FastaVectorString sequence;
  struct FastaVectorString header;
  struct FastaVectorMetadataVector metadata;
};

struct FastaVectorLocalPosition {
  size_t sequenceIndex;
  size_t positionInSequence;
};

enum FastaVectorReturnCode fastaVectorInit(struct FastaVector *v);
void fastaVectorDealloc(struct FastaVector *v);
void fastaVectorStringDealloc(struct FastaVectorString *s);
enum FastaVectorReturnCode fastaVectorReadFasta(const char *fileSrc,
                                                struct FastaVector *v);
void fastaVectorGetHeader(struct FastaVector *v, size_t sequenceIndex,
                          char **headerPtr, size_t *headerLength);
bool fastaVectorGetLocalSequencePositionFromGlobal(
    const struct FastaVector *v, size_t globalPosition,
    struct FastaVectorLocalPosition *out);

#endif
