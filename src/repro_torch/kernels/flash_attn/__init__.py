"""Causal, padded online-softmax attention (flash attention): CUDA kernel, plain version, oracle."""
