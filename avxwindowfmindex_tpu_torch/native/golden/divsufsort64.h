/* divsufsort64 shim — golden-parity build support.
 *
 * The reference calls exactly one libdivsufsort entry point
 * (AwFmCreate.c:99-100, 230-231): fill SA[0..n) with the start
 * positions of the lexicographically sorted suffixes of T[0..n),
 * returning 0 on success. This shim provides that contract backed by
 * this repo's own SA-IS (native/src/awfm_host.cpp awfm_suffix_array),
 * letting the reference sources compile into a golden binary. Suffix
 * order is a function of the input alone, so WHICH suffix sorter runs
 * underneath cannot change the golden bytes.
 */
#ifndef DIVSUFSORT64_H
#define DIVSUFSORT64_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

int64_t divsufsort64(const uint8_t *T, int64_t *SA, int64_t n);

#ifdef __cplusplus
}
#endif

#endif
