"""Device ops: rank primitives, the seed-table builder and the CUDA kernels."""
