"""Shared numpy fixtures for the port's parity tests: each test builds its
inputs here once and hands the same arrays to both packages."""
import numpy as np


def irregular_slate(N, K, seed=0, min_degree=0):
    """Padded (idx (N, K) int32, valid (N, K) bool) with per-node degrees
    in [min_degree, K]; padded slots repeat the node's own index."""
    rng = np.random.default_rng(seed)
    idx = np.zeros((N, K), np.int32)
    valid = np.zeros((N, K), bool)
    for n in range(N):
        v = int(rng.integers(min_degree, K + 1))
        if v:
            idx[n, :v] = rng.choice([i for i in range(N) if i != n], size=v,
                                    replace=False)
        idx[n, v:] = n
        valid[n, :v] = True
    return idx, valid


def with_degree_zero(idx, valid, node=1):
    """Force ``node``'s slate empty (all invalid, all self)."""
    idx, valid = idx.copy(), valid.copy()
    idx[node] = node
    valid[node] = False
    return idx, valid


def ring_slate(N, K):
    """Regular slate: node n reads n+1 .. n+K (mod N)."""
    return np.asarray([[(n + o) % N for o in range(1, K + 1)]
                       for n in range(N)], np.int32)


def models(N, d, seed, shift=0.3):
    return (np.random.default_rng(seed).standard_normal((N, d))
            .astype(np.float32) + np.float32(shift))
