"""Port parity of the d-sharded gossip round: ``repro_torch.distributed.
spmd`` on S ``gloo`` ranks (spawned CPU processes, ``_torch_spmd_child``;
they import no JAX) against the JAX package in this process.

* The shard body: S in {2, 8} ranks, WFAgg and Alt-WFAgg, four rounds
  with temporal state, against ``jax.vmap`` of the reference's
  ``spmd._shard_round_body`` over the zero-padded shards with
  ``axis_name="model"`` (its ``psum`` runs under ``vmap``); masks
  bit-equal, weights within 1e-6, ``out`` within 2e-4, ``hist_s`` within
  1e-4 (``tests/_spmd_parity_main.py:65-69, 86-90``); every rank's
  results bit-identical, and bit-identical to the one-process emulation
  ``wfagg_batch_sharded_emulated``.
* The scan: S = 2, three churned rounds, against the JAX loop of
  ``realign_temporal_history`` + ``wfagg_batch(fused_two_launch)``
  (``check_scan``'s single-device reference).
* The engine: S = 2, ``build_round_fn(dynamic=True)``, two MLP rounds,
  against the JAX engine unsharded on ``fused_two_launch`` within 3e-4
  (``_spmd_parity_main.py:175-182``), every rank's state bit-identical.
* The refusals: ``psum_stats`` of d-sized centers, per-edge prev, a d the
  scan cannot split, sharding without a group or with a group of another
  size, the chaos round with shards."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wfagg as jwf
from repro.core.topology import make_topology as jmake_topology
from repro.data.synthetic import SyntheticImages as JImages
from repro.dfl import engine as jengine
from repro.distributed import spmd as jspmd
from repro_torch.core import wfagg as twf
from repro_torch.core.topology import make_topology
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.dfl import dynamics as tdyn
from repro_torch.dfl import engine as tengine
from repro_torch.dfl import faults as tflt
from repro_torch.distributed import spmd
from repro_torch.kernels.robust_stats.ref import RobustStats
from repro_torch.models.lenet import params_from_jax, ravel

from _torch_fixtures import jax_batches
from _torch_spmd_child import run_ranks, same_on_every_rank

N, K, D = 10, 4, 1003          # d/S: 502 at S=2, 126 at S=8 (both 2 mod 4)
ROUNDS = 4
MASKS = ("mask_d", "mask_c", "mask_t")


def _cfgs(alt):
    kw = dict(backend="fused_two_launch", f=1, window=3, transient=1)
    if alt:
        kw.update(distance_filter="multi_krum", similarity_filter="clustering",
                  multi_krum_m=2)
    return jwf.WFAggConfig(**kw), twf.WFAggConfig(**kw)


def _table(rng):
    return np.stack([rng.choice(np.delete(np.arange(N), n), size=K, replace=False)
                     for n in range(N)]).astype(np.int32)


def _round_models(seed, rounds):
    """A slowly moving centre, fresh spread each round, one Byzantine row
    scaled 40x (so the filters reject something)."""
    rng = np.random.default_rng(seed)
    centre = rng.normal(size=(1, D)).astype(np.float32)
    out = []
    for r in range(rounds):
        m = centre + np.float32(0.05 * r) + rng.normal(size=(N, D)).astype(np.float32)
        m[3] *= 40.0
        out.append(m.astype(np.float32))
    return out


_vmapped = {}


def _vmap_body(cfg, S):
    """The reference's shard body under ``jax.vmap`` over S shards."""
    key = (cfg, S)
    if key not in _vmapped:
        TS = jwf.TemporalState
        sharded = TS(prev=0, hist_s=None, hist_b=None, count=None, t=None)
        _vmapped[key] = jax.jit(jax.vmap(
            jspmd._shard_round_body(cfg, "model"),
            in_axes=(0, 0, sharded, None, None), out_axes=(0, sharded, None),
            axis_name="model"))
    return _vmapped[key]


def _to_shards(x, S):
    p = np.asarray(jspmd.pad_to_shards(jnp.asarray(x), S))
    return p.reshape(p.shape[0], S, -1).transpose(1, 0, 2)


def _from_shards(x, d):
    x = np.asarray(x)
    return x.transpose(1, 0, 2).reshape(x.shape[1], -1)[:, :d]


def _jax_rounds(cfg, S, rounds, idx, prev0):
    """Every round through the vmapped shard body, the state carried."""
    st = jspmd.batched_matrix_state(N, K, D, cfg.window)._replace(
        prev=jnp.asarray(prev0))
    valid = jnp.ones((N, K), bool)
    res = []
    for m in rounds:
        sh = jnp.asarray(_to_shards(m, S))
        st_sh = st._replace(prev=jnp.asarray(_to_shards(np.asarray(st.prev), S)))
        out, ns, (md, mc, mt, w) = _vmap_body(cfg, S)(sh, sh, st_sh, jnp.asarray(idx),
                                                      valid)
        st = ns._replace(prev=jnp.asarray(_from_shards(ns.prev, D)))
        res.append({"out": _from_shards(out, D), "mask_d": np.asarray(md),
                    "mask_c": np.asarray(mc), "mask_t": np.asarray(mt),
                    "weights": np.asarray(w), "hist_s": np.asarray(st.hist_s),
                    "prev": np.asarray(st.prev)})
    return res


@pytest.mark.parametrize("alt", [False, True], ids=["wfagg", "alt_wfagg"])
@pytest.mark.parametrize("S", [2, 8])
def test_shard_body_matches_vmapped_reference(S, alt, tmp_path):
    jcfg, tcfg = _cfgs(alt)
    rng = np.random.default_rng(7)
    idx = _table(rng)
    rounds = _round_models(8 + S + int(alt), ROUNDS)
    prev0 = (rounds[0] * np.float32(0.97)).astype(np.float32)
    want = _jax_rounds(jcfg, S, rounds, idx, prev0)
    ranks = run_ranks("round", S, tmp_path, cfg=tcfg, rounds=rounds, idx=idx, prev0=prev0)
    assert same_on_every_rank(ranks)
    got = ranks[0]
    seen = {m: [False, False] for m in MASKS}
    for r, (g, w) in enumerate(zip(got, want)):
        for m in MASKS:
            assert np.array_equal(g[m], w[m]), (r, m)
            seen[m][0] |= bool(g[m].any())
            seen[m][1] |= bool((~g[m]).any())
        np.testing.assert_allclose(g["weights"], w["weights"], atol=1e-6, err_msg=str(r))
        np.testing.assert_allclose(g["out"], w["out"], rtol=2e-4, atol=2e-4, err_msg=str(r))
        np.testing.assert_allclose(g["state"]["prev"], w["prev"], rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(g["state"]["hist_s"], w["hist_s"], rtol=2e-4,
                                   atol=1e-4)
    # every filter both accepted and rejected somewhere
    assert all(a and b for a, b in seen.values()), seen

    # the one-process emulation: the same kernels per shard, the same sums
    state = spmd.batched_matrix_state(N, K, D, tcfg.window)._replace(
        prev=torch.as_tensor(prev0))
    for r, m in enumerate(rounds):
        mt = torch.as_tensor(m)
        out, state, info = spmd.wfagg_batch_sharded_emulated(
            mt, mt, state, tcfg, torch.as_tensor(idx), n_shards=S, device="cpu")
        assert out.numpy().tobytes() == got[r]["out"].tobytes(), r
        assert info["weights"].numpy().tobytes() == got[r]["weights"].tobytes(), r
        assert state.hist_s.numpy().tobytes() == got[r]["state"]["hist_s"].tobytes(), r


def test_scan_matches_reference_loop(tmp_path):
    """S = 2, three churned rounds (``_spmd_parity_main.py:44-57``), against
    the JAX single-device loop of realign + ``wfagg_batch``."""
    S, R = 2, 3
    jcfg, tcfg = _cfgs(False)
    rng = np.random.default_rng(8)
    models = rng.normal(size=(N, D)).astype(np.float32)
    models[3] *= 40.0
    idx = _table(rng)
    sched_idx = np.stack([np.roll(idx, r, axis=1) for r in range(R)]).astype(np.int32)
    sched_valid = np.ones((R, N, K), bool)
    for r in range(1, R):
        sched_valid[r, np.arange(N), (np.arange(N) + r) % K] = False

    m_ref = jnp.asarray(models)
    st_ref = jspmd.batched_matrix_state(N, K, D, jcfg.window)._replace(prev=m_ref)
    prev_idx, prev_val = jnp.asarray(sched_idx[0]), jnp.ones((N, K), bool)
    for r in range(R):
        i, v = jnp.asarray(sched_idx[r]), jnp.asarray(sched_valid[r])
        st_ref = jwf.realign_temporal_history(st_ref, prev_idx, prev_val, i, v)
        m_ref, st_ref, _ = jwf.wfagg_batch(m_ref, m_ref, st_ref, jcfg,
                                           neighbor_idx=i, valid=v)
        prev_idx, prev_val = i, v

    pad = spmd.pad_to_shards(torch.as_tensor(models), S).numpy()
    ranks = run_ranks("scan", S, tmp_path, cfg=tcfg, models=pad, prev=pad,
                      sched_idx=sched_idx, sched_valid=sched_valid, bad_d=D)
    assert all(r["refused"] for r in ranks)
    m_sh = np.concatenate([r["models"] for r in ranks], axis=1)[:, :D]
    prev_sh = np.concatenate([r["state"]["prev"] for r in ranks], axis=1)[:, :D]
    np.testing.assert_allclose(m_sh, np.asarray(m_ref), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(prev_sh, np.asarray(st_ref.prev), rtol=2e-4, atol=2e-4)
    for r in ranks:
        np.testing.assert_allclose(r["state"]["hist_s"], np.asarray(st_ref.hist_s),
                                   rtol=2e-4, atol=1e-4)
        assert r["state"]["hist_s"].tobytes() == ranks[0]["state"]["hist_s"].tobytes()


def test_sharded_engine_matches_unsharded_reference_engine(tmp_path):
    """S = 2, two dynamic churn rounds of the MLP (IPM-100) from the JAX
    engine's initial weights and batches, against the JAX engine
    unsharded on ``fused_two_launch``: parameters within 3e-4, verdicts
    bit-equal, every rank's models and momentum bit-identical."""
    S, R = 2, 2
    jtopo = jmake_topology(N, K, 2, "ring", seed=0)
    topo = make_topology(N, K, 2, "ring", seed=0)
    sched = tdyn.churn_schedule(topo, R, seed=1)
    jdata = JImages()
    jcfg = jengine.DFLConfig(aggregator="wfagg", attack="ipm_100", model="mlp",
                             wfagg_backend="fused_two_launch", batches_per_round=2)
    jfn = jengine.build_round_fn(jcfg, jtopo, jdata, dynamic=True, telemetry=True)
    jst = jax.jit(lambda: jengine.init_dfl_state(jcfg, jtopo, degree=sched.width))()
    params = {k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.array, jst.node_params)).items()}
    batches = [jax_batches(jdata, N, r, 2, jcfg.paper.batch_size) for r in range(R)]
    want = []
    prev = (sched.neighbor_idx[0], sched.valid[0])
    for r in range(R):
        idx, val, mal = sched.neighbor_idx[r], sched.valid[r], sched.malicious[r]
        jst = jst._replace(temporal=jwf.realign_temporal_history(
            jst.temporal, *(jnp.asarray(x) for x in (*prev, idx, val))))
        jst, jrec = jfn(jst, jnp.asarray(idx), jnp.asarray(val), jnp.asarray(mal))
        want.append((np.asarray(jengine._ravel_nodes(jst.node_params)[0]),
                     np.asarray(jrec.verdict)))
        prev = (idx, val)

    cfg = tengine.DFLConfig(aggregator="wfagg", attack="ipm_100", model="mlp",
                            wfagg_backend="fused_two_launch", batches_per_round=2,
                            mesh_model_shards=S)
    ranks = run_ranks("engine", S, tmp_path, cfg=cfg, topo=topo, params=params,
                      sched=sched, batches=batches)
    assert same_on_every_rank(ranks)
    for r, (got, (flat, verdict)) in enumerate(zip(ranks[0], want)):
        np.testing.assert_allclose(got["flat"], flat, rtol=3e-4, atol=3e-4,
                                   err_msg=f"round {r}")
        assert np.array_equal(got["verdict"], verdict), r


def test_alt_wfagg_sharded_engine_keeps_ranks_identical(tmp_path):
    """Alt-WFAgg (the Gram rides along in kernel 2's shard statistics)
    through the sharded static round of ``run``-style rounds: every rank
    ends each round with bit-identical models, momentum and history, and
    the models equal the unsharded ``fused_two_launch`` engine's within
    3e-4 from the same start."""
    S, R = 2, 2
    topo = make_topology(N, K, 2, "ring", seed=0)
    sched = tdyn.churn_schedule(topo, R, seed=3)
    jdata = JImages()
    batches = [jax_batches(jdata, N, r, 2, 32) for r in range(R)]
    base = tengine.DFLConfig(aggregator="alt_wfagg", attack="ipm_100", model="mlp",
                             wfagg_backend="fused_two_launch", batches_per_round=2)
    params = {k: v.numpy() for k, v in tengine.init_dfl_state(
        base, topo, degree=sched.width, device="cpu").node_params.items()}
    ranks = run_ranks("engine", S, tmp_path, cfg=dataclasses.replace(
        base, mesh_model_shards=S), topo=topo, params=params, sched=sched,
        batches=batches)
    assert same_on_every_rank(ranks)
    fn = tengine.build_round_fn(base, topo, SyntheticImages(), dynamic=True,
                                telemetry=True, device="cpu")
    st = tengine.init_dfl_state(base, topo, degree=sched.width, device="cpu")
    st = st._replace(node_params={k: torch.as_tensor(v) for k, v in params.items()})
    prev = (sched.neighbor_idx[0], sched.valid[0])
    for r in range(R):
        idx, val, mal = (torch.as_tensor(x[r]) for x in (
            sched.neighbor_idx, sched.valid, sched.malicious))
        st = st._replace(temporal=twf.realign_temporal_history(
            st.temporal, *(torch.as_tensor(x) for x in prev), idx, val))
        st, rec = fn(st, idx, val, mal, batches=batches[r])
        np.testing.assert_allclose(ranks[0][r]["flat"], ravel(st.node_params).numpy(),
                                   rtol=3e-4, atol=3e-4, err_msg=f"round {r}")
        prev = (sched.neighbor_idx[r], sched.valid[r])


def test_refusals(tmp_path):
    stats = RobustStats(med=torch.zeros(3), trim=None, dist2=torch.zeros(2, 2),
                        dotmed=torch.zeros(2, 2), norm2=torch.zeros(2, 2),
                        mednorm2=torch.zeros(2))
    with pytest.raises(ValueError, match="d-sized centers"):
        spmd.psum_stats(stats, group=None)
    _, tcfg = _cfgs(False)
    per_edge = twf.TemporalState(prev=torch.zeros(N, K, 8), hist_s=torch.zeros(N, 3, K),
                                 hist_b=torch.zeros(N, 3, K),
                                 count=torch.zeros(N, dtype=torch.int32),
                                 t=torch.zeros(N, dtype=torch.int32))
    m = torch.zeros(N, 8)
    idx = torch.as_tensor(_table(np.random.default_rng(0)))
    with pytest.raises(NotImplementedError, match="per-edge"):
        spmd.wfagg_batch_sharded(m, m, per_edge, tcfg, idx, device="cpu")
    with pytest.raises(NotImplementedError, match="per-edge"):
        spmd.wfagg_scan_sharded(m, per_edge, tcfg, idx[None], torch.ones(1, N, K, dtype=bool),
                                device="cpu")
    # no initialised process group: sharding raises, never runs unsharded
    with pytest.raises(ValueError, match="initialised torch.distributed"):
        spmd.wfagg_batch_sharded(m, m, None, tcfg, idx, device="cpu")
    with pytest.raises(ValueError, match="initialised torch.distributed"):
        spmd.aggregation_group(2)
    topo = make_topology(N, K, 2, "ring", seed=0)
    cfg = tengine.DFLConfig(aggregator="wfagg", model="mlp", mesh_model_shards=2)
    with pytest.raises(ValueError, match="initialised torch.distributed"):
        tengine.build_round_fn(cfg, topo, SyntheticImages(), device="cpu")
    with pytest.raises(ValueError, match="initialised torch.distributed"):
        tengine.build_round_fn(cfg, topo, SyntheticImages(), dynamic=True, device="cpu")
    # the chaos round refuses sharding, as the reference does
    with pytest.raises(NotImplementedError, match="not sharded yet"):
        tengine.build_round_fn(cfg, topo, SyntheticImages(), dynamic=True,
                               faults=tflt.FaultConfig(), device="cpu")
    # CFL and the baselines ignore the field, as in the reference
    for kw in (dict(aggregator="mean"), dict(aggregator="wfagg", centralized=True)):
        tengine.build_round_fn(dataclasses.replace(cfg, **kw), topo, SyntheticImages(),
                               device="cpu")
    # a group of another size than the shard count
    S = 2
    msgs = run_ranks("group_size", S, tmp_path, cfg=dataclasses.replace(
        cfg, mesh_model_shards=S + 1), topo=topo)
    for m1, m2 in msgs:
        assert m1 is not None and "has 2 ranks" in m1 and "3 shards" in m1
        assert m2 is not None and "has 2 ranks" in m2


def test_shard_columns_pad_and_split_as_the_reference():
    x = np.arange(2 * 11, dtype=np.float32).reshape(2, 11)
    for S in (1, 2, 3, 4, 8):
        want = _to_shards(x, S)
        for r in range(S):
            got = spmd.shard_columns(torch.as_tensor(x), r, S)
            assert got.is_contiguous() and np.array_equal(got.numpy(), want[r]), (S, r)
        assert spmd.shard_padded_d(11, S) == jspmd.shard_padded_d(11, S)
        assert np.array_equal(spmd.pad_to_shards(torch.as_tensor(x), S).numpy(),
                              np.asarray(jspmd.pad_to_shards(jnp.asarray(x), S)))
    st = spmd.batched_matrix_state(3, 2, 5, 4)
    ref = jspmd.batched_matrix_state(3, 2, 5, 4)
    for a, b in zip(st, ref):
        assert tuple(a.shape) == b.shape and str(a.dtype).endswith(str(b.dtype))
