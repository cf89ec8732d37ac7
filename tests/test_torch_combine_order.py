"""Kernels 3 and 7 of the port (``kernels/weighted_agg/csrc/
weighted_agg_indexed.cu`` and ``weighted_agg.cu``) on the CPU: their plain
versions, which the kernels equal bit for bit on the card, and kernel 3's
launch plan.

* The plain versions through the ``ops`` wrappers against the JAX package's
  ``weighted_agg`` / ``weighted_agg_indexed`` with their Pallas kernels in
  interpret mode, at D % 4 = 1, 2, 3 (no padding in the port) and K = 1, 7,
  16, 32, on an irregular slate with a degree-0 row, on a stacked chaos
  matrix (M > N rows, built by the port's ``apply_transport``), and with a
  NaN row of weight 0 (NaN in the same places): within 3e-5
  (``tests/test_one_launch.py:20``), exactly ``local`` where every weight
  is 0.
* The plain versions are the kernels' order: ``lcoef * local``, then each
  slot's product added in slot order, every op rounded to float32 (a
  numpy emulation, bit for bit).
* The ``ops`` wrappers return contiguous outputs of width d.
* ``kernel.combine_plan`` covers every node exactly once, fits 227 KB of
  shared memory, and takes the whole slate as one group (G = N) at (M, N,
  K) = (64, 64, 16), at the paper's static slate (20, 20, 8) and its
  chaos stack (84, 20, 8).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.weighted_agg import ops as jwops
from repro_torch.core.trust import combine_coefficients
from repro_torch.dfl import faults as tflt
from repro_torch.kernels.weighted_agg import kernel as wkernel
from repro_torch.kernels.weighted_agg import ops as wops

from _torch_fixtures import irregular_slate, models, with_degree_zero

COMBINE_TOL = 3e-5
WIDTHS = (257, 258, 259)          # D % 4 = 1, 2, 3
SLOTS = (1, 7, 16, 32)


def _weights(shape, seed):
    w = np.random.default_rng(seed).uniform(0.2, 1.0, shape).astype(np.float32)
    w[np.random.default_rng(seed + 1).random(shape) < 0.3] = 0.0
    return w


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("K", SLOTS)
def test_combine_matches_pallas_kernel(K, d):
    u = models(K, d, seed=K)
    local = models(1, d, seed=K + 1, shift=-0.2)[0]
    w = _weights((K,), seed=K + 2)
    before = wkernel.launches
    got = wops.weighted_agg(torch.as_tensor(local), torch.as_tensor(u), torch.as_tensor(w))
    assert wkernel.launches == before                    # CPU: plain version
    want = jwops.weighted_agg(jnp.asarray(local), jnp.asarray(u), jnp.asarray(w), alpha=0.8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=COMBINE_TOL,
                               atol=COMBINE_TOL)
    zero = wops.weighted_agg(torch.as_tensor(local), torch.as_tensor(u), torch.zeros(K))
    assert np.array_equal(zero.numpy(), local)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("K", SLOTS)
def test_indexed_combine_matches_pallas_kernel(K, d):
    N = max(K + 2, 9)
    idx, valid = with_degree_zero(*irregular_slate(N, K, seed=K, min_degree=1))
    m = models(N, d, seed=K + 3)
    local = models(N, d, seed=K + 4, shift=-0.2)
    w = np.where(valid, _weights((N, K), seed=K + 5), 0.0).astype(np.float32)
    before = wkernel.indexed_launches
    got = wops.weighted_agg_indexed(torch.as_tensor(local), torch.as_tensor(m),
                                    torch.as_tensor(idx), torch.as_tensor(w))
    assert wkernel.indexed_launches == before
    want = jwops.weighted_agg_indexed(jnp.asarray(local), jnp.asarray(m), jnp.asarray(idx),
                                      jnp.asarray(w), alpha=0.8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=COMBINE_TOL,
                               atol=COMBINE_TOL)
    keep = w.sum(1) == 0                   # the degree-0 row, and any all-rejected one
    assert keep[1]
    np.testing.assert_array_equal(got.numpy()[keep], local[keep])


def test_indexed_combine_on_a_stacked_chaos_matrix():
    """M > N rows: this round's models, a ring of three past matrices and the
    corrupt bank, read through the effective table of ``apply_transport``."""
    N, K, d = 12, 5, 203
    idx, valid = with_degree_zero(*irregular_slate(N, K, seed=7, min_degree=1))
    rng = np.random.default_rng(8)
    fcfg = tflt.FaultConfig()
    flat = torch.as_tensor(models(N, d, seed=9))
    ring = torch.as_tensor(models(fcfg.ring_depth * N, d, seed=10).reshape(
        fcfg.ring_depth, N, d))
    fr = tflt.FaultRound(torch.as_tensor(rng.random((N, K)) < 0.2),
                         torch.as_tensor(rng.integers(0, 3, (N, K)).astype(np.int32)),
                         torch.as_tensor(rng.random((N, K)) < 0.1),
                         torch.as_tensor(rng.random((N, K)) < 0.3),
                         torch.zeros(N, dtype=torch.bool))
    served = torch.as_tensor(rng.integers(0, 3, (N, K)).astype(np.int32))
    tout = tflt.apply_transport(flat, tflt.TransportState(ring, served), torch.as_tensor(idx),
                                torch.as_tensor(valid), fr, fcfg, 3)
    full, eff_idx = tout.full.numpy(), tout.eff_idx.numpy().astype(np.int32)
    assert full.shape[0] > N and eff_idx.max() >= N        # rows past the models read
    w = np.where(tout.eff_valid.numpy(), _weights((N, K), seed=11), 0.0).astype(np.float32)
    local = flat.numpy()
    got = wops.weighted_agg_indexed(torch.as_tensor(local), torch.as_tensor(full),
                                    torch.as_tensor(eff_idx), torch.as_tensor(w))
    want = jwops.weighted_agg_indexed(jnp.asarray(local), jnp.asarray(full),
                                      jnp.asarray(eff_idx), jnp.asarray(w), alpha=0.8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=COMBINE_TOL,
                               atol=COMBINE_TOL)


def test_a_nan_row_of_weight_zero_stays_nan():
    """No slot is skipped: a zero weight times a NaN row is NaN, in the port
    as in the reference, in both combines."""
    K, d, N = 6, 258, 8
    u = models(K, d, seed=12)
    u[2, 100] = np.nan
    w = _weights((K,), seed=13)
    w[2] = 0.0
    local = models(1, d, seed=14)[0]
    got = wops.weighted_agg(torch.as_tensor(local), torch.as_tensor(u), torch.as_tensor(w))
    want = jwops.weighted_agg(jnp.asarray(local), jnp.asarray(u), jnp.asarray(w), alpha=0.8)
    assert np.isnan(got.numpy()[100]) and np.isnan(np.asarray(want)[100])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=COMBINE_TOL,
                               atol=COMBINE_TOL)
    m = models(N, d, seed=15)
    m[3, 7] = np.nan
    idx = np.asarray([[(n + o) % N for o in range(1, 4)] for n in range(N)], np.int32)
    wi = np.where(idx == 3, 0.0, _weights((N, 3), seed=16)).astype(np.float32)
    lm = models(N, d, seed=17)
    got = wops.weighted_agg_indexed(torch.as_tensor(lm), torch.as_tensor(m),
                                    torch.as_tensor(idx), torch.as_tensor(wi))
    want = np.asarray(jwops.weighted_agg_indexed(jnp.asarray(lm), jnp.asarray(m),
                                                 jnp.asarray(idx), jnp.asarray(wi),
                                                 alpha=0.8))
    reads = (idx == 3).any(1)
    assert np.isnan(got.numpy()[reads, 7]).all() and np.isnan(want[reads, 7]).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=COMBINE_TOL, atol=COMBINE_TOL)


def _kernel_order(wvec, lcoef, local, rows):
    """The kernels' arithmetic in numpy float32: ``lcoef * local``, then
    ``+ wvec[k] * rows[k]`` for k = 0 .. K-1, each op rounded."""
    out = np.float32(lcoef) * local
    for k in range(rows.shape[0]):
        out = out + np.float32(wvec[k]) * rows[k]
    return out


@pytest.mark.parametrize("K", SLOTS)
def test_plain_versions_are_the_kernels_order(K):
    d, N = 259, 6
    u = models(K, d, seed=20 + K)
    local = models(1, d, seed=21)[0]
    wvec, lcoef = combine_coefficients(torch.as_tensor(_weights((K,), seed=22 + K)), 0.8)
    got = wops.weighted_agg_plain(wvec, lcoef.reshape(1), torch.as_tensor(local),
                                  torch.as_tensor(u)).numpy()
    assert np.array_equal(got, _kernel_order(wvec.numpy(), lcoef.numpy(), local, u))
    m = models(K + 3, d, seed=23)
    idx = np.random.default_rng(24).integers(0, K + 3, (N, K)).astype(np.int32)
    lm = models(N, d, seed=25)
    wv, lc = combine_coefficients(torch.as_tensor(_weights((N, K), seed=26)), 0.8)
    got = wops.weighted_agg_indexed_plain(wv, lc, torch.as_tensor(lm), torch.as_tensor(m),
                                          torch.as_tensor(idx)).numpy()
    for n in range(N):
        assert np.array_equal(got[n], _kernel_order(wv[n].numpy(), lc[n].numpy(), lm[n],
                                                    m[idx[n]]))


@pytest.mark.parametrize("d", WIDTHS)
def test_wrappers_return_contiguous_rows_of_width_d(d):
    N, K = 5, 3
    m = torch.as_tensor(models(N, d, seed=30))
    idx = torch.as_tensor(np.asarray([[(n + o) % N for o in range(1, K + 1)]
                                      for n in range(N)], np.int32))
    out = wops.weighted_agg_indexed(m, m, idx, torch.ones((N, K)))
    assert out.shape == (N, d) and out.is_contiguous() and out.dtype == torch.float32
    out = wops.weighted_agg(m[0], m[1:], torch.ones(N - 1))
    assert out.shape == (d,) and out.is_contiguous() and out.dtype == torch.float32


PLAN_SHAPES = (
    (64, 64, 16, 1 << 20),     # the timed ring
    (20, 20, 8, 44426),        # the paper's static slate
    (84, 20, 8, 44426),        # its chaos stack: M + L M + C rows
    (260, 64, 16, 1 << 20),    # the timed ring's chaos stack
    (628, 48, 32, 20011),      # a ring of 12 past matrices: more rows than fit
    (5000, 1000, 32, 100),
    (1, 65535, 32, 10),
    (3, 7, 5, 37),
)


@pytest.mark.parametrize("M, N, K, D", PLAN_SHAPES)
def test_combine_plan_covers_every_node_once_within_shared_memory(M, N, K, D):
    p = wkernel.combine_plan(M, N, K, D)
    G = p["group"]
    nodes = [n for g in range(p["n_groups"]) for n in range(g * G, min(N, (g + 1) * G))]
    assert nodes == list(range(N))
    assert p["rows"] == min(M, G * K) + G
    assert p["smem"] == wkernel._smem_bytes(p["rows"], G, K, p["tile"], p["stages"])
    assert p["smem"] <= 227 * 1024
    assert p["tile"] in (32, 64, 128) and p["tile"] >= 32
    assert wkernel.MIN_STAGES <= p["stages"] <= wkernel.MAX_STAGES
    assert p["n_tiles"] * p["tile"] >= D > (p["n_tiles"] - 1) * p["tile"]
    if G < N:                  # a larger group would not fit three stages
        assert wkernel._smem_bytes(min(M, (G + 1) * K) + G + 1, G + 1, K, 32,
                                   wkernel.MIN_STAGES) > wkernel.SMEM_BYTES


@pytest.mark.parametrize("M, N, K, D", PLAN_SHAPES[:3])
def test_combine_plan_takes_the_whole_slate(M, N, K, D):
    assert wkernel.combine_plan(M, N, K, D)["group"] == N


def test_combine_plan_splits_a_deep_stack_and_rejects_unported_shapes():
    assert wkernel.combine_plan(628, 48, 32, 20011)["group"] < 48
    for M, N, K in ((64, 64, 1025), (64, 65536, 8), (0, 4, 2)):
        with pytest.raises(ValueError, match="combine_plan takes"):
            wkernel.combine_plan(M, N, K, 100)
