"""Port parity of the single-node WFAgg pipeline (``repro_torch.core.wfagg.
wfagg`` and its filters) against the JAX package's, as the CFL server
runs it: K = 10 candidates with two bit-identical attackers, five calls
with ``transient=3`` so WFAgg-T turns on in the last two, for WFAgg and
Alt-WFAgg (Multi-Krum + Clustering) on the fused backend (on the CPU: the
plain versions of the statistics, Gram and combine kernels; JAX: its
Pallas kernels in interpret mode) and on the reference backend.  Masks
must be bit-equal, ``out`` within rtol = atol = 3e-5
(``tests/test_one_launch.py:20``), the temporal history within 1e-5."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wfagg as jwf
from repro_torch.core import wfagg as twf
from repro_torch.kernels.pairwise_dist import kernel as pkernel
from repro_torch.kernels.robust_stats import kernel as rkernel
from repro_torch.kernels.weighted_agg import kernel as wkernel

ATOL = 3e-5
MASKS = ("mask_d", "mask_c", "mask_t")
K, D, CALLS = 10, 256, 5


def _round_inputs(rng, base):
    """Benign candidates near ``base``, two attackers (rows 0 and 4)
    sending one bit-identical IPM-like model, and the anchor."""
    u = (base + 0.1 * rng.standard_normal((K, D))).astype(np.float32)
    u[0] = u[4] = (-2.0 * base).astype(np.float32)
    return u, base.astype(np.float32)


def _configs(alt, backend):
    kw = dict(transient=3, backend=backend)
    if alt:
        return jwf.alt_wfagg_config(multi_krum_m=3, **kw), \
            twf.alt_wfagg_config(multi_krum_m=3, **kw)
    return jwf.WFAggConfig(**kw), twf.WFAggConfig(**kw)


@pytest.mark.parametrize("backend", ["fused", "reference"])
@pytest.mark.parametrize("alt", [False, True], ids=["wfagg", "alt_wfagg"])
def test_wfagg_matches_reference_over_calls(alt, backend):
    jcfg, tcfg = _configs(alt, backend)
    rng = np.random.default_rng(5 + alt)
    base = rng.standard_normal(D)
    jstate = jwf.init_temporal_state(K, D, jcfg.window)
    tstate = twf.init_temporal_state(K, D, tcfg.window)
    counts = (rkernel.robust_stats_launches, pkernel.launches, wkernel.launches)
    t_fired = 0
    for call in range(CALLS):
        u, local = _round_inputs(rng, base)
        jout, jstate, jinfo = jwf.wfagg(jnp.asarray(local), jnp.asarray(u), jstate, jcfg)
        tout, tstate, tinfo = twf.wfagg(torch.as_tensor(local), torch.as_tensor(u),
                                        tstate, tcfg)
        for m in MASKS:
            np.testing.assert_array_equal(tinfo[m].numpy(), np.asarray(jinfo[m]),
                                          err_msg=f"call {call} {m}")
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=ATOL, atol=ATOL)
        assert int(tinfo["n_accepted"]) == int(jinfo["n_accepted"])
        for name in ("hist_s", "hist_b"):
            np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                       np.asarray(getattr(jstate, name)),
                                       rtol=1e-5, atol=1e-5)
        assert int(tstate.count) == int(jstate.count) and int(tstate.t) == int(jstate.t)
        assert torch.equal(tstate.prev, torch.as_tensor(u))
        t_fired += int(tinfo["mask_t"].sum())
        base = 0.7 * base + 0.3 * tout.numpy()
    assert t_fired > 0, "WFAgg-T never accepted a candidate"
    # the attackers are rejected on every call
    assert not tinfo["weights"][[0, 4]].any()
    # CPU tensors: the plain versions, never a kernel launch
    assert counts == (rkernel.robust_stats_launches, pkernel.launches, wkernel.launches)


@pytest.mark.parametrize("alt", [False, True], ids=["wfagg", "alt_wfagg"])
def test_wfagg_without_temporal_state(alt):
    jcfg, tcfg = _configs(alt, "fused")
    u, local = _round_inputs(np.random.default_rng(9), np.ones(D))
    jout, jnone, jinfo = jwf.wfagg(jnp.asarray(local), jnp.asarray(u), None, jcfg)
    tout, tnone, tinfo = twf.wfagg(torch.as_tensor(local), torch.as_tensor(u), None, tcfg)
    assert jnone is None and tnone is None
    assert not tinfo["mask_t"].any()
    for m in MASKS:
        np.testing.assert_array_equal(tinfo[m].numpy(), np.asarray(jinfo[m]))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=ATOL, atol=ATOL)


def test_filters_match_reference():
    rng = np.random.default_rng(13)
    u, _ = _round_inputs(rng, rng.standard_normal(D))
    ju, tu = jnp.asarray(u), torch.as_tensor(u)
    for f in (1, 2):
        np.testing.assert_array_equal(twf.wfagg_d_select(tu, f).numpy(),
                                      np.asarray(jwf.wfagg_d_select(ju, f)))
        np.testing.assert_array_equal(twf.wfagg_c_select(tu, f).numpy(),
                                      np.asarray(jwf.wfagg_c_select(ju, f)))
    ja, jclip = jwf.wfagg_c_stats(ju)
    ta, tclip = twf.wfagg_c_stats(tu)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tclip.numpy(), np.asarray(jclip), rtol=1e-5, atol=1e-6)
    cfg_j, cfg_t = jwf.WFAggConfig(transient=0), twf.WFAggConfig(transient=0)
    js = jwf.init_temporal_state(K, D, 3)
    ts = twf.init_temporal_state(K, D, 3)
    for call in range(3):
        v = (u + 0.05 * call * rng.standard_normal((K, D))).astype(np.float32)
        jm, js = jwf.wfagg_t_select(js, jnp.asarray(v), cfg_j)
        tm, ts = twf.wfagg_t_select(ts, torch.as_tensor(v), cfg_t)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        np.testing.assert_allclose(ts.hist_s.numpy(), np.asarray(js.hist_s), rtol=1e-5)
    w = np.linspace(0, 1, K).astype(np.float32)
    np.testing.assert_allclose(
        twf.wfagg_e(tu[1], tu, torch.as_tensor(w), 0.8).numpy(),
        np.asarray(jwf.wfagg_e(ju[1], ju, jnp.asarray(w), 0.8)), rtol=ATOL, atol=ATOL)


def test_two_launch_backend_is_the_fused_pipeline_for_one_node():
    """As in the reference, a single-node call has no single-launch
    variant: "fused_two_launch" runs the fused pipeline."""
    _, tcfg = _configs(False, "fused")
    u, local = _round_inputs(np.random.default_rng(2), np.ones(D))
    a = twf.wfagg(torch.as_tensor(local), torch.as_tensor(u), None, tcfg)
    b = twf.wfagg(torch.as_tensor(local), torch.as_tensor(u), None,
                  dataclasses.replace(tcfg, backend="fused_two_launch"))
    assert torch.equal(a[0], b[0])
    with pytest.raises(ValueError, match="unknown backend"):
        twf.wfagg(torch.as_tensor(local), torch.as_tensor(u), None,
                  dataclasses.replace(tcfg, backend="nope"))
