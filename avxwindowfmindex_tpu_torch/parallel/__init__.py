"""Batch search API, shard retry, the chunked corpus and the
query-parallel engine over a list of devices."""
