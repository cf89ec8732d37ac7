"""Shared fixtures for the port's parity tests: each test builds its
inputs here once, in numpy, and hands the same arrays to both packages;
``jax_batches`` draws the reference engine's own per-node batches.

Importing this module makes the process's torch single-threaded.  The
suite runs under pytest-xdist, several worker processes on the machine's
cores, and every worker imports this module while it collects the tests;
with torch's default of one OpenMP thread per core the workers' threads
oversubscribe the cores and spin: six workers each running the same three
trainer tests took 180 s apiece at 8 threads and 9 s at 1 (one process
alone: 10.7 s and 9.1 s) on an 8-core machine."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)


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


@functools.lru_cache(maxsize=None)
def _batch_drawer(data, N, batch_size):
    """The jitted draw of one round's batch ``b`` for every node, compiled
    once a process for each (data, N, batch_size)."""
    @jax.jit
    def draw(rnd, b):
        keys = jax.vmap(lambda n: jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(data.seed), n), rnd * 1000 + b))(
                jnp.arange(N))
        return jax.vmap(lambda k: data.batch(k, batch_size))(keys)
    return draw


def jax_batches(data, N, rnd, n_batches, batch_size):
    """The reference engine's per-node batches of round ``rnd`` as numpy
    arrays, drawn with the same ``fold_in`` keys as
    ``repro/dfl/engine.py:157``."""
    draw = _batch_drawer(data, N, batch_size)
    return [tuple(np.array(x) for x in draw(rnd, b)) for b in range(n_batches)]


def reference_sketch_hash(n, m, seed, chunk_idx, device):
    """The reference's count-sketch buckets and signs (the ``jax.random``
    draws of ``repro.distributed.robust_allreduce._count_sketch``), in the
    form the port's ``robust_allreduce.sketch_hash`` returns them."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), chunk_idx)
    kb, ks = jax.random.split(key)
    buckets = np.asarray(jax.random.randint(kb, (n,), 0, m))
    signs = np.asarray(jax.random.rademacher(ks, (n,), jnp.float32))
    return (torch.as_tensor(buckets.astype(np.int64), device=device),
            torch.as_tensor(signs.copy(), device=device))
