"""Port parity of the two-launch gossip backend: ``repro_torch``'s
gather-free statistics (``robust_stats_indexed``) and combine
(``weighted_agg_indexed``) wrappers on the CPU (their plain PyTorch
versions) against the JAX package's Pallas kernels in interpret mode, and
``wfagg_batch`` on ``backend="fused_two_launch"`` against the JAX
package's same backend.  Statistics within rtol = atol = 1e-5 (float32
sums in another order), the Gram within rtol 1e-5; aggregates within
rtol = atol = 3e-5 (``tests/test_one_launch.py:20``), masks bit-equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wfagg as jwf
from repro.kernels.robust_stats import ops as jrops
from repro.kernels.weighted_agg import ops as jwops
from repro_torch.core import wfagg as twf
from repro_torch.kernels.robust_stats import kernel as trkernel
from repro_torch.kernels.robust_stats import ops as trops
from repro_torch.kernels.weighted_agg import kernel as twkernel
from repro_torch.kernels.weighted_agg import ops as twops

from _torch_fixtures import irregular_slate, models, ring_slate, with_degree_zero

ATOL = 3e-5
TOL = 1e-5
FIELDS = ("dist2", "dotmed", "norm2", "mednorm2", "prev_dist2", "prev_dot",
          "prev_norm2")
_jax_wfagg_batch = jax.jit(jwf.wfagg_batch, static_argnames=("cfg",))


def _slate(kind, N=7, K=5):
    if kind == "regular":
        return ring_slate(N, K), None
    return with_degree_zero(*irregular_slate(N, K, seed=4, min_degree=1))


def _t(x):
    return None if x is None else torch.as_tensor(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("need_gram", [False, True])
@pytest.mark.parametrize("with_prev", [False, True])
@pytest.mark.parametrize("slate", ["regular", "irregular"])
def test_indexed_stats_wrapper_matches_pallas_kernel(slate, with_prev, need_gram):
    idx, valid = _slate(slate)
    N, K = idx.shape
    d = 203                                  # not a multiple of any tile
    m = models(N, d, seed=1)
    m[2] = m[5]                              # two bit-identical rows
    prev = models(N, d, seed=3, shift=0.1) if with_prev else None
    launches = trkernel.indexed_launches
    got = trops.robust_stats_indexed(_t(m), _t(idx), _t(valid), _t(prev),
                                     need_gram=need_gram)
    want = jrops.robust_stats_indexed(_j(m), _j(idx), _j(valid), _j(prev),
                                      need_gram=need_gram)
    assert trkernel.indexed_launches == launches      # CPU tensors: plain version
    for name in FIELDS:
        g = getattr(got, name)
        if not with_prev and name.startswith("prev"):
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)
    if need_gram:
        np.testing.assert_allclose(got.gram.numpy(), np.asarray(want.gram),
                                   rtol=TOL, atol=TOL)
    else:
        assert got.gram is None


def test_indexed_stats_wrapper_rejects_unported_and_bad_input():
    idx = torch.as_tensor(ring_slate(6, 3))
    u = torch.as_tensor(models(6, 64, seed=5))
    with pytest.raises(ValueError, match="matrix-form prev"):
        trops.robust_stats_indexed(u, idx, prev=u[idx], prev_idx=idx)   # per-edge prev
    with pytest.raises(ValueError, match="per-edge prev has shape"):
        trops.robust_stats_indexed(u, idx, prev=u[idx][:, :2])
    with pytest.raises(ValueError, match="outside"):
        trops.robust_stats_indexed(u, idx, prev=u, prev_idx=torch.where(idx == 2, 6, idx))
    with pytest.raises(ValueError, match="outside"):
        trops.robust_stats_indexed(u, torch.where(idx == 2, 6, idx))
    with pytest.raises(ValueError, match="cuda or cpu"):
        trops.robust_stats_indexed(u.to("meta"), idx.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        trkernel.robust_stats_indexed_cuda(u, idx.int(), torch.ones((6, 3), dtype=torch.bool),
                                           None, False)


@pytest.mark.parametrize("slate", ["regular", "irregular"])
def test_indexed_combine_matches_pallas_kernel(slate):
    idx, valid = _slate(slate, N=8, K=4)
    N, K = idx.shape
    d = 301
    m = models(N, d, seed=6)
    local = models(N, d, seed=7, shift=-0.2)
    w = np.random.default_rng(8).uniform(0.2, 1.0, (N, K)).astype(np.float32)
    w[3] = 0.0                               # all rejected: keeps its local model
    if valid is not None:
        w = np.where(valid, w, 0.0).astype(np.float32)
    launches = twkernel.indexed_launches
    got = twops.weighted_agg_indexed(_t(local), _t(m), _t(idx), _t(w), alpha=0.8)
    assert twkernel.indexed_launches == launches
    want = jwops.weighted_agg_indexed(_j(local), _j(m), _j(idx), _j(w), alpha=0.8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ATOL, atol=ATOL)
    keep = (w.sum(1) == 0)
    np.testing.assert_array_equal(got.numpy()[keep], local[keep])
    zero = twops.weighted_agg_indexed(_t(local), _t(m), _t(idx),
                                      torch.zeros((N, K)), alpha=0.8)
    assert torch.equal(zero, torch.as_tensor(local))


def test_indexed_combine_wrapper_rejects_bad_input():
    idx = torch.as_tensor(ring_slate(6, 3))
    u = torch.as_tensor(models(6, 64, seed=5))
    w = torch.ones((6, 3))
    with pytest.raises(ValueError, match="outside"):
        twops.weighted_agg_indexed(u, u, torch.where(idx == 2, -1, idx), w)
    with pytest.raises(ValueError, match="expected"):
        twops.weighted_agg_indexed(u, u, idx, w[:, :2])
    with pytest.raises(ValueError, match="cuda or cpu"):
        twops.weighted_agg_indexed(u.to("meta"), u.to("meta"), idx.to("meta"),
                                   w.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        twkernel.weighted_agg_indexed_cuda(w, w[:, 0], u, u, idx.int())


@pytest.mark.parametrize("slate", ["regular", "irregular"])
def test_wfagg_two_launch_matches_jax_two_launch(slate):
    """WFAgg on the two-launch backend over several rounds of live temporal
    state (``transient=1``, so the bands are finite and ``mask_t`` fires)."""
    idx, valid = _slate(slate, N=9, K=5)
    N, K = idx.shape
    d, W = 190, 3
    jcfg = jwf.WFAggConfig(backend="fused_two_launch", transient=1, f=1)
    tcfg = twf.WFAggConfig(backend="fused_two_launch", transient=1, f=1)
    jst = jwf.TemporalState(
        prev=jnp.zeros((N, d)), hist_s=jnp.zeros((N, W, K)),
        hist_b=jnp.zeros((N, W, K)), count=jnp.zeros((N,), jnp.int32),
        t=jnp.zeros((N,), jnp.int32))
    tst = twf.TemporalState(*(torch.as_tensor(np.array(x)) for x in jst))
    fired = False
    for r in range(5):
        u = models(N, d, seed=40 + r)
        jout, jst, jinfo = _jax_wfagg_batch(jnp.asarray(u), jnp.asarray(u), jst,
                                            cfg=jcfg, neighbor_idx=jnp.asarray(idx),
                                            valid=_j(valid))
        out, tst, info = twf.wfagg_batch(_t(u), _t(u), tst, tcfg, neighbor_idx=_t(idx),
                                         valid=_t(valid), device="cpu")
        for m in ("mask_d", "mask_c", "mask_t"):
            assert np.array_equal(info[m].numpy(), np.asarray(jinfo[m])), (r, m)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=ATOL, atol=ATOL)
        np.testing.assert_allclose(tst.hist_s.numpy(), np.asarray(jst.hist_s),
                                   rtol=1e-5, atol=1e-5)
        assert tst.prev.shape == (N, d)
        fired |= bool(info["mask_t"].any())
    assert fired, "the temporal filter never accepted an edge"
