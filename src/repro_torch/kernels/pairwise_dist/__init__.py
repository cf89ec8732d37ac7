"""The (K, K) candidate Gram of Krum, Multi-Krum and Clustering: CUDA kernel, plain version, oracle."""
