/* Golden-parity driver: exercises the REFERENCE library's public API
 * (built from the read-only sources with the shims in this directory)
 * so its on-disk bytes and answers can be compared against this repo's
 * TPU implementation. See tools/golden_parity.py (build + compare CLI)
 * and tests/test_golden_reference.py.
 *
 * Commands (all output line-oriented ASCII on stdout):
 *   create-raw   <seqfile> <alphabet> <ratio> <k> <storeSeq> <out.awfmi>
 *   create-fasta <fasta>   <alphabet> <ratio> <k> <storeSeq> <out.awfmi>
 *       alphabet: amino|dna|rna   (AwFmIndex.h:29-33)
 *   count  <index.awfmi> <kmers.txt> <inMemorySa>
 *       per kmer: "<count>"
 *   locate <index.awfmi> <kmers.txt> <inMemorySa>
 *       per kmer: "<count> <pos> <pos> ..." (reference positionList order)
 *   localize <index.awfmi> <pos> [<pos> ...]
 *       per position: "<seqnum> <localpos> <header>"
 */
#define _POSIX_C_SOURCE 200809L /* strdup under -std=c17 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "AwFmIndex.h"

static enum AwFmAlphabetType parseAlphabet(const char *s) {
  if (strcmp(s, "amino") == 0) {
    return AwFmAlphabetAmino;
  }
  if (strcmp(s, "rna") == 0) {
    return AwFmAlphabetRna;
  }
  return AwFmAlphabetDna;
}

static char **readLines(const char *path, size_t *numOut) {
  FILE *fh = fopen(path, "rb");
  if (!fh) {
    return NULL;
  }
  char **lines = NULL;
  size_t num = 0, cap = 0;
  char buf[4096];
  while (fgets(buf, sizeof(buf), fh)) {
    size_t len = strlen(buf);
    while (len > 0 && (buf[len - 1] == '\n' || buf[len - 1] == '\r')) {
      buf[--len] = '\0';
    }
    if (len == 0) {
      continue;
    }
    if (num == cap) {
      cap = cap ? cap * 2 : 64;
      lines = realloc(lines, cap * sizeof(char *));
    }
    lines[num++] = strdup(buf);
  }
  fclose(fh);
  *numOut = num;
  return lines;
}

static int cmdCreate(int argc, char **argv, bool fromFasta) {
  if (argc != 8) {
    fprintf(stderr, "bad args\n");
    return 2;
  }
  struct AwFmIndexConfiguration config = {
      .suffixArrayCompressionRatio = (uint8_t)atoi(argv[4]),
      .kmerLengthInSeedTable = (uint8_t)atoi(argv[5]),
      .alphabetType = parseAlphabet(argv[3]),
      .keepSuffixArrayInMemory = true,
      .storeOriginalSequence = atoi(argv[6]) != 0,
  };
  struct AwFmIndex *index = NULL;
  enum AwFmReturnCode rc;
  if (fromFasta) {
    rc = awFmCreateIndexFromFasta(&index, &config, argv[2], argv[7]);
  } else {
    FILE *fh = fopen(argv[2], "rb");
    if (!fh) {
      fprintf(stderr, "cannot open %s\n", argv[2]);
      return 2;
    }
    fseek(fh, 0, SEEK_END);
    long n = ftell(fh);
    rewind(fh);
    uint8_t *seq = malloc(n);
    if (fread(seq, 1, n, fh) != (size_t)n) {
      fprintf(stderr, "short read\n");
      return 2;
    }
    fclose(fh);
    rc = awFmCreateIndex(&index, &config, seq, n, argv[7]);
    free(seq);
  }
  if (rc < 0) {
    fprintf(stderr, "create failed: %d\n", (int)rc);
    return 1;
  }
  printf("ok bwtLength %llu\n", (unsigned long long)index->bwtLength);
  awFmDeallocIndex(index);
  return 0;
}

static int cmdSearch(int argc, char **argv, bool locate) {
  if (argc != 5) {
    fprintf(stderr, "bad args\n");
    return 2;
  }
  struct AwFmIndex *index = NULL;
  enum AwFmReturnCode rc =
      awFmReadIndexFromFile(&index, argv[2], atoi(argv[4]) != 0);
  if (rc < 0) {
    fprintf(stderr, "read failed: %d\n", (int)rc);
    return 1;
  }
  size_t numKmers = 0;
  char **kmers = readLines(argv[3], &numKmers);
  if (!kmers) {
    fprintf(stderr, "cannot read kmers\n");
    return 2;
  }
  struct AwFmKmerSearchList *searchList = awFmCreateKmerSearchList(numKmers);
  searchList->count = numKmers;
  for (size_t i = 0; i < numKmers; i++) {
    searchList->kmerSearchData[i].kmerString = kmers[i];
    searchList->kmerSearchData[i].kmerLength = strlen(kmers[i]);
  }
  if (locate) {
    awFmParallelSearchLocate(index, searchList, 2);
    for (size_t i = 0; i < numKmers; i++) {
      struct AwFmKmerSearchData *d = &searchList->kmerSearchData[i];
      printf("%u", d->count);
      for (uint32_t j = 0; j < d->count; j++) {
        printf(" %llu", (unsigned long long)d->positionList[j]);
      }
      printf("\n");
    }
  } else {
    awFmParallelSearchCount(index, searchList, 2);
    for (size_t i = 0; i < numKmers; i++) {
      printf("%u\n", searchList->kmerSearchData[i].count);
    }
  }
  awFmDeallocKmerSearchList(searchList);
  awFmDeallocIndex(index);
  return 0;
}

static int cmdLocalize(int argc, char **argv) {
  if (argc < 4) {
    fprintf(stderr, "bad args\n");
    return 2;
  }
  struct AwFmIndex *index = NULL;
  enum AwFmReturnCode rc = awFmReadIndexFromFile(&index, argv[2], true);
  if (rc < 0) {
    fprintf(stderr, "read failed: %d\n", (int)rc);
    return 1;
  }
  for (int i = 3; i < argc; i++) {
    size_t global = strtoull(argv[i], NULL, 10);
    size_t seqNum = 0, local = 0;
    rc = awFmGetLocalSequencePositionFromIndexPosition(index, global, &seqNum,
                                                       &local);
    if (rc != AwFmSuccess) {
      printf("err %d\n", (int)rc);
      continue;
    }
    char *header = NULL;
    size_t headerLength = 0;
    rc = awFmGetHeaderStringFromSequenceNumber(index, seqNum, &header,
                                               &headerLength);
    printf("%zu %zu %.*s\n", seqNum, local,
           rc == AwFmSuccess ? (int)headerLength : 0,
           rc == AwFmSuccess ? header : "");
  }
  awFmDeallocIndex(index);
  return 0;
}

int main(int argc, char **argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: golden_driver <command> ...\n");
    return 2;
  }
  if (strcmp(argv[1], "create-raw") == 0) {
    return cmdCreate(argc, argv, false);
  }
  if (strcmp(argv[1], "create-fasta") == 0) {
    return cmdCreate(argc, argv, true);
  }
  if (strcmp(argv[1], "count") == 0) {
    return cmdSearch(argc, argv, false);
  }
  if (strcmp(argv[1], "locate") == 0) {
    return cmdSearch(argc, argv, true);
  }
  if (strcmp(argv[1], "localize") == 0) {
    return cmdLocalize(argc, argv);
  }
  fprintf(stderr, "unknown command %s\n", argv[1]);
  return 2;
}
