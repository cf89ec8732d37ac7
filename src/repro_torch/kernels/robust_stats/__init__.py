"""The single-launch WFAgg round: CUDA kernel, plain version, oracle."""
