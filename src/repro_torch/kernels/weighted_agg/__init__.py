"""The single-node WFAgg-E combine: CUDA kernel, plain version, oracle."""
