"""Batch search API, shard retry, the chunked corpus, the query-parallel
engine and the range-sharded engine over a list of devices."""
