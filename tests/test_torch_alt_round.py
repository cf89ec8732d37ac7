"""Port parity of decentralized Alt-WFAgg (Multi-Krum + Clustering as the
distance and similarity filters, paper Section VI-B2): ``repro_torch``'s
``wfagg_batch(neighbor_idx=…, cfg=alt_wfagg_config())`` on the CPU under
the backends "fused" (the round kernel's Gram variant's plain version)
and "fused_two_launch" (the plain versions of the statistics and combine
kernels), against the JAX package's ``wfagg_batch`` under all three of
its backends (the Pallas kernels in interpret mode).  Slates: a regular
ring, an irregular slate with a degree-0 row, and a ring whose two
attackers send one bit-identical model; with live temporal state
(``transient=1``, so ``mask_t`` fires) and without.  Masks bit-equal,
aggregates within rtol = atol = 3e-5 (``tests/test_one_launch.py:20``),
degree-0 rows equal to their local model within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wfagg as jwf
from repro_torch.core import wfagg as twf
from repro_torch.kernels.robust_stats import kernel as tkernel

from _torch_fixtures import irregular_slate, models, ring_slate, with_degree_zero

ATOL = 3e-5
JAX_BACKENDS = ("fused", "fused_two_launch", "reference")
PORT_BACKENDS = ("fused", "fused_two_launch")
MASKS = ("mask_d", "mask_c", "mask_t")
_jax_wfagg_batch = jax.jit(jwf.wfagg_batch, static_argnames=("cfg",))


def _scenario(name):
    """(idx, valid or None, the pair of rows sent bit-identical or None)."""
    if name == "ring":
        return ring_slate(10, 5), None, None
    if name == "irregular":
        idx, valid = with_degree_zero(*irregular_slate(9, 5, seed=8, min_degree=1))
        return idx, valid, None
    return ring_slate(10, 5), None, (0, 2)          # "tied"


@pytest.mark.parametrize("temporal", [True, False])
@pytest.mark.parametrize("scenario", ["ring", "irregular", "tied"])
def test_alt_round_matches_jax_backends(scenario, temporal):
    idx, valid, tied = _scenario(scenario)
    N, K = idx.shape
    d, W = 160, 3
    kw = dict(transient=1, f=1, multi_krum_m=2, use_temporal=temporal)
    jcfg = {b: jwf.alt_wfagg_config(backend=b, **kw) for b in JAX_BACKENDS}
    tcfg = {b: twf.alt_wfagg_config(backend=b, **kw) for b in PORT_BACKENDS}
    jst0 = jwf.TemporalState(
        prev=jnp.zeros((N, d)), hist_s=jnp.zeros((N, W, K)),
        hist_b=jnp.zeros((N, W, K)), count=jnp.zeros((N,), jnp.int32),
        t=jnp.zeros((N,), jnp.int32)) if temporal else None
    jst = dict.fromkeys(JAX_BACKENDS, jst0)
    tst = dict.fromkeys(PORT_BACKENDS, None if not temporal else twf.TemporalState(
        *(torch.as_tensor(np.array(x)) for x in jst0)))
    launches = tkernel.launches, tkernel.indexed_launches
    fired = False
    for r in range(4 if temporal else 1):
        u = models(N, d, seed=110 + r)
        if tied is not None:                 # two attackers, one model
            u[list(tied)] = -3.0 * u.mean(0)
        jouts, jinfo = {}, {}
        for b in JAX_BACKENDS:
            # the JAX reference backend's valid-aware path needs a mask
            v = valid if valid is not None or b != "reference" else np.ones((N, K), bool)
            jouts[b], jst[b], jinfo[b] = _jax_wfagg_batch(
                jnp.asarray(u), jnp.asarray(u), jst[b], cfg=jcfg[b],
                neighbor_idx=jnp.asarray(idx),
                valid=None if v is None else jnp.asarray(v))
        for b in PORT_BACKENDS:
            out, tst[b], info = twf.wfagg_batch(
                torch.as_tensor(u), torch.as_tensor(u), tst[b], tcfg[b],
                neighbor_idx=torch.as_tensor(idx),
                valid=None if valid is None else torch.as_tensor(valid), device="cpu")
            for jb in JAX_BACKENDS:
                for m in MASKS:
                    assert np.array_equal(info[m].numpy(), np.asarray(jinfo[jb][m])), \
                        (scenario, r, b, jb, m)
                np.testing.assert_allclose(out.numpy(), np.asarray(jouts[jb]),
                                           rtol=ATOL, atol=ATOL,
                                           err_msg=f"{scenario} r{r} {b}/{jb}")
            if valid is not None:
                deg0 = ~valid.any(1)
                np.testing.assert_allclose(out.numpy()[deg0], u[deg0],
                                           rtol=1e-6, atol=1e-6)
            if tied is not None:             # Multi-Krum and Clustering both met the tie
                assert not info["mask_c"].numpy()[np.isin(idx, tied)].any()
            fired |= bool(info["mask_t"].any())
            if temporal:
                assert tst[b].prev.shape == (N, d)
    assert fired == temporal, "the temporal filter never accepted an edge"
    assert (tkernel.launches, tkernel.indexed_launches) == launches  # CPU: plain
