"""Robust statistics: the single-launch WFAgg round and the single-matrix statistics (CUDA kernels, plain versions, oracles)."""
