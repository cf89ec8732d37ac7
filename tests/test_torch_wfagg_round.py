"""Port parity of the gather-free WFAgg round: ``repro_torch``
``wfagg_batch(neighbor_idx=…)`` under backend "fused" (on the CPU: the
round kernel's plain PyTorch version) and "reference", against the JAX
package's ``wfagg_batch`` under all three of its backends (the Pallas
kernels in interpret mode).  Mirrors ``tests/test_one_launch.py``: live
temporal state over several rounds with ``transient=1`` (so the bands
are finite and ``mask_t`` fires), a ring slate, an irregular slate with a
degree-0 row, and a NaN row for the sanitizer.  Masks bit-equal, ``out``
within rtol = atol = 3e-5 (``test_one_launch.py:20``), degree-0 rows equal
their local model within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wfagg as jwf
from repro_torch.core import wfagg as twf
from repro_torch.kernels.robust_stats import kernel as tkernel
from repro_torch.kernels.robust_stats import ops as tops

from _torch_fixtures import irregular_slate, models, ring_slate, with_degree_zero

ATOL = 3e-5
JAX_BACKENDS = ("fused", "fused_two_launch", "reference")
PORT_BACKENDS = ("fused", "reference")
MASKS = ("mask_d", "mask_c", "mask_t")
# the reference as it is, compiled once per backend and shape
_jax_wfagg_batch = jax.jit(jwf.wfagg_batch, static_argnames=("cfg",))


def _jax_state(N, K, d, W):
    return jwf.TemporalState(
        prev=jnp.zeros((N, d)), hist_s=jnp.zeros((N, W, K)),
        hist_b=jnp.zeros((N, W, K)), count=jnp.zeros((N,), jnp.int32),
        t=jnp.zeros((N,), jnp.int32))


def _port_state(N, K, d, W):
    return twf.TemporalState(
        prev=torch.zeros((N, d)), hist_s=torch.zeros((N, W, K)),
        hist_b=torch.zeros((N, W, K)), count=torch.zeros((N,), dtype=torch.int32),
        t=torch.zeros((N,), dtype=torch.int32))


def _scenario(name):
    """(idx, valid or None, rounds, rows to poison with NaN)."""
    if name == "ring":
        return ring_slate(10, 4), None, 6, ()
    if name == "irregular":
        idx, valid = with_degree_zero(*irregular_slate(9, 5, seed=8, min_degree=1))
        return idx, valid, 5, ()
    return ring_slate(8, 4), None, 5, (3,)          # "nan"


@pytest.mark.parametrize("scenario", ["ring", "irregular", "nan"])
def test_round_matches_jax_backends(scenario):
    idx, valid, rounds, nan_rows = _scenario(scenario)
    N, K = idx.shape
    d = 190
    kw = dict(transient=1, f=1)
    jcfg = {b: jwf.WFAggConfig(backend=b, **kw) for b in JAX_BACKENDS}
    tcfg = {b: twf.WFAggConfig(backend=b, **kw) for b in PORT_BACKENDS}
    jst = {b: _jax_state(N, K, d, 3) for b in JAX_BACKENDS}
    tst = {b: _port_state(N, K, d, 3) for b in PORT_BACKENDS}
    # the JAX reference backend takes its valid-aware path only when given
    # a mask (without one, a sanitized NaN row stays a valid zero row)
    jvalid = valid if valid is not None or not nan_rows else np.ones((N, K), bool)
    launches = tkernel.launches
    fired = False
    for r in range(rounds):
        u = models(N, d, seed=70 + r)
        u[list(nan_rows)] = np.nan
        jouts, jinfo = {}, {}
        for b in JAX_BACKENDS:
            v = jvalid if b == "reference" else valid
            jouts[b], jst[b], jinfo[b] = _jax_wfagg_batch(
                jnp.asarray(u), jnp.asarray(u), jst[b], cfg=jcfg[b],
                neighbor_idx=jnp.asarray(idx),
                valid=None if v is None else jnp.asarray(v))
        for b in PORT_BACKENDS:
            out, tst[b], info = twf.wfagg_batch(
                torch.as_tensor(u), torch.as_tensor(u), tst[b], tcfg[b],
                neighbor_idx=torch.as_tensor(idx),
                valid=None if valid is None else torch.as_tensor(valid),
                device="cpu")
            for jb in JAX_BACKENDS:
                for m in MASKS:
                    assert np.array_equal(info[m].numpy(), np.asarray(jinfo[jb][m])), \
                        (scenario, r, b, jb, m)
                np.testing.assert_allclose(
                    out.numpy()[np.isfinite(u).all(1)],
                    np.asarray(jouts[jb])[np.isfinite(u).all(1)],
                    rtol=ATOL, atol=ATOL, err_msg=f"{scenario} r{r} {b}/{jb}")
            assert np.isfinite(out.numpy()[np.isfinite(u).all(1)]).all()
            if valid is not None:
                deg0 = ~valid.any(1)
                np.testing.assert_allclose(out.numpy()[deg0], u[deg0],
                                           rtol=1e-6, atol=1e-6)
            if nan_rows:
                # the poisoned row is demoted on every edge that reads it
                assert not info["valid"].numpy()[np.isin(idx, nan_rows)].any()
            fired |= bool(info["mask_t"].any())
        np.testing.assert_allclose(tst["fused"].hist_s.numpy(),
                                   np.asarray(jst["fused"].hist_s),
                                   rtol=1e-5, atol=1e-5)
        assert tst["fused"].prev.shape == (N, d)     # matrix state kept
    assert fired, "the temporal filter never accepted an edge"
    assert tkernel.launches == launches              # CPU tensors: plain version


def test_regular_matches_unmasked_and_no_temporal():
    """valid=None runs with an implicit all-true mask (= the explicit
    all-ones mask), also without temporal state."""
    idx = torch.as_tensor(ring_slate(8, 4))
    u = torch.as_tensor(models(8, 300, seed=4, shift=0.1))
    cfg = twf.WFAggConfig(use_temporal=False)
    o1, _, i1 = twf.wfagg_batch(u, u, None, cfg, neighbor_idx=idx, device="cpu")
    o2, _, i2 = twf.wfagg_batch(u, u, None, cfg, neighbor_idx=idx,
                                valid=torch.ones((8, 4), dtype=torch.bool),
                                device="cpu")
    assert torch.equal(i1["mask_d"], i2["mask_d"])
    torch.testing.assert_close(o1, o2, rtol=0, atol=1e-6)


def test_wrapper_dispatches_by_device_and_rejects_unported_variants():
    idx = torch.as_tensor(ring_slate(6, 3))
    u = torch.as_tensor(models(6, 64, seed=5))
    cfg = twf.WFAggConfig()
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.wfagg_round_indexed(u.to("meta"), u.to("meta"), idx.to("meta"),
                                 None, cfg)
    for bad in (-1, 6):
        with pytest.raises(ValueError, match="outside"):
            tops.wfagg_round_indexed(u, u, torch.where(idx == 2, bad, idx), None, cfg)
    with pytest.raises(ValueError, match="outside"):
        tops.wfagg_round_indexed(u, u, idx, None, cfg, prev=u,
                                 prev_idx=torch.where(idx == 2, -1, idx))
    with pytest.raises(ValueError, match="matrix-form prev"):      # per-edge prev
        tops.wfagg_round_indexed(u, u, idx, None, cfg, prev=u[idx], prev_idx=idx)
    with pytest.raises(ValueError, match="per-edge prev has shape"):
        tops.wfagg_round_indexed(u, u, idx, None, cfg, prev=u[idx][:, :, :9])
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.wfagg_round_indexed_cuda(u, u, idx.int(), None, None, None,
                                         cfg, 0.8, False)
