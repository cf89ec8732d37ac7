"""Port parity of the flat layout of the robust all-reduce:
``repro_torch.distributed.robust_allreduce.robust_allreduce`` and
``apply_distributed_attack`` on ``Emulated(K)`` (the K candidates as one
(K, d) tensor in one process) against the reference's functions under
``jax.vmap(..., axis_name="data")``, on the same numpy candidates, with
the reference's count-sketch bits injected (``sketch_hash``, the port's
own draws otherwise): masks bit-equal, weights within 1e-6, output within
rtol 2e-5 / atol 1e-6 (``tests/test_system.py:297-300``), over 3 calls
with WFAgg-T state.  Then 4 spawned ``gloo`` ranks on the CPU (one per
candidate; ``tests/_torch_spmd_child.py``) bit-equal to each other and to
the emulation, and mirrors of ``tests/test_system.py``'s
``test_robust_allreduce_consensus_identical_output`` and
``test_stacked_layout_matches_flat_layout``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import wfagg as jwf
from repro.distributed import robust_allreduce as jra
from repro_torch.core import wfagg as twf
from repro_torch.distributed import robust_allreduce as tra

import _torch_spmd_child as child
from _torch_fixtures import reference_sketch_hash

METHODS = ("mean", "median", "trimmed_mean", "krum", "multi_krum", "clustering",
           "wfagg", "alt_wfagg")
D, CHUNK, SKETCH = 1000, 256, 64      # d not a multiple of the chunk
W_TOL, RTOL, ATOL = 1e-6, 2e-5, 1e-6


@pytest.fixture
def reference_bits(monkeypatch):
    monkeypatch.setattr(tra, "sketch_hash", functools.lru_cache(maxsize=None)(
        reference_sketch_hash))


def _configs(method, K, **kw):
    w = dict(f=1 if K == 4 else 2, transient=1, window=2)
    return (jra.RobustAggConfig(method=method, wfagg=jwf.WFAggConfig(**w),
                                chunk_size=CHUNK, sketch_dim=SKETCH, **kw),
            tra.RobustAggConfig(method=method, wfagg=twf.WFAggConfig(**w),
                                chunk_size=CHUNK, sketch_dim=SKETCH, **kw))


def _rounds(K, seed=0, n=3, d=D):
    """n rounds of K candidates: a shared drift, a scaled candidate 1."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(d).astype(np.float32)
    out = []
    for r in range(n):
        x = base + 0.5 * rng.standard_normal((K, d)).astype(np.float32) + 0.1 * r
        x[1] *= 8.0
        out.append(x.astype(np.float32))
    return out


def _row0(tree):
    return jax.tree.map(lambda a: np.asarray(a)[0], tree)


@pytest.mark.parametrize("K", [4, 8])
@pytest.mark.parametrize("method", METHODS)
def test_flat_allreduce_matches_reference(method, K, reference_bits):
    cj, ct = _configs(method, K)
    temporal = method in ("wfagg", "alt_wfagg")
    sj = jra.init_agg_state(cj, K) if temporal else None
    st = tra.init_agg_state(ct, K) if temporal else None
    fn = jax.jit(jax.vmap(lambda f, s: jra.robust_allreduce(f, "data", cj, s),
                          in_axes=(0, None), axis_name="data"))
    for r, x in enumerate(_rounds(K, seed=K)):
        oj, sj_new, ij = fn(jnp.asarray(x), sj)
        ot, st, it = tra.robust_allreduce(torch.as_tensor(x), tra.Emulated(K), ct, st)
        label = f"{method} K={K} round {r}"
        assert ot.shape == (D,)
        # every candidate of the reference holds the same output
        assert np.array_equal(np.asarray(oj), np.broadcast_to(np.asarray(oj)[0], oj.shape))
        np.testing.assert_allclose(it["weights"].numpy(), np.asarray(ij["weights"])[0],
                                   atol=W_TOL, err_msg=label)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj)[0], rtol=RTOL, atol=ATOL,
                                   err_msg=label)
        assert int(it["n_accepted"]) == int(np.asarray(ij["n_accepted"])[0]), label
        if temporal:
            for m in ("mask_d", "mask_c", "mask_t"):
                assert np.array_equal(it[m].numpy(), np.asarray(ij[m])[0]), (label, m)
            sj = _row0(sj_new)
            np.testing.assert_allclose(st.temporal.prev.numpy(), sj.temporal.prev,
                                       rtol=1e-5, atol=1e-5, err_msg=label)
            np.testing.assert_allclose(st.temporal.hist_s.numpy(), sj.temporal.hist_s,
                                       rtol=1e-5, err_msg=label)
            assert int(st.temporal.count) == int(sj.temporal.count)
    if temporal:     # WFAgg-T acted: some candidate passed or failed it
        assert int(sj.temporal.t) >= 1


@pytest.mark.parametrize("attack", ["sign_flip", "ipm_0.5", "ipm_100", "alie"])
def test_distributed_attack_matches_reference(attack):
    K = 8
    x = _rounds(K, seed=3, n=1)[0]
    mal = np.zeros(K, bool)
    mal[[2, 5]] = True
    fn = jax.vmap(lambda f: jra.apply_distributed_attack(
        f, "data", jnp.asarray(mal), attack, jax.random.PRNGKey(0)), axis_name="data")
    want = np.asarray(fn(jnp.asarray(x)))
    got = tra.apply_distributed_attack(torch.as_tensor(x), tra.Emulated(K),
                                       torch.as_tensor(mal), attack, chunk_size=CHUNK)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=1e-6, err_msg=attack)
    assert np.array_equal(got.numpy()[~mal], x[~mal])


def test_noise_attack_adds_one_draw_on_every_malicious_worker():
    """The same draws on each malicious row: whole-vector chunk c of
    ``chunk_size`` normals from a generator seeded by (the generator's
    seed, c) (``noise_chunk``), the vector's last chunk cut to its end."""
    K = 4
    x = torch.as_tensor(_rounds(K, n=1)[0])
    mal = torch.tensor([False, True, False, True])
    g = torch.Generator().manual_seed(4)
    got = tra.apply_distributed_attack(x, tra.Emulated(K), mal, "noise", g, chunk_size=CHUNK)
    z = torch.cat([tra.noise_chunk(tra._seed(4, c), CHUNK, "cpu")
                   for c in range(-(-D // CHUNK))])[:D]
    want = x + 0.1 + 0.1 * z[None]      # one draw, added on each malicious row
    assert torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])
    assert torch.equal(got[0], x[0]) and torch.equal(got[2], x[2])


@pytest.mark.parametrize("method,attack", [("wfagg", "alie"), ("alt_wfagg", "ipm_100"),
                                           ("median", "sign_flip"), ("mean", "ipm_0.5")])
def test_gloo_ranks_bit_equal_to_each_other_and_the_emulation(method, attack, tmp_path):
    """4 spawned gloo ranks, one per candidate: every rank's output, weights,
    masks and state bit-equal to every other's and to the emulation's
    (both gather each chunk and add in rank order)."""
    K = 4
    _, ct = _configs(method, K)
    mal = np.zeros(K, bool)
    mal[2] = True
    res = child.run_ranks("flat", K, tmp_path, cfg=ct, rounds=_rounds(K, seed=9),
                          malicious=mal, attack=attack)
    ranks = [r["rank"] for r in res]
    shared = [[{k: v for k, v in rd.items() if k != "attacked"} for rd in r] for r in ranks]
    assert child.same_on_every_rank(shared)
    emulated = res[0]["emulated"]
    for r in range(3):
        for k in shared[0][r]:
            assert child.same_on_every_rank([shared[0][r][k], emulated[r][k]]), (r, k)
        for rank in range(K):
            assert ranks[rank][r]["attacked"][0].tobytes() == \
                emulated[r]["attacked"][rank].tobytes(), (r, rank)


def test_robust_allreduce_consensus_identical_output():
    """tests/test_system.py::test_robust_allreduce_consensus_identical_output,
    emulated: 4 candidates of d = 3000 in chunks of 1024."""
    cfg = tra.RobustAggConfig(method="wfagg", chunk_size=1024,
                              wfagg=twf.WFAggConfig(f=1, use_temporal=False))
    x = torch.randn((4, 3000), generator=torch.Generator().manual_seed(0))
    out, _, info = tra.robust_allreduce(x, tra.Emulated(4), cfg, None)
    assert out.shape == (3000,)
    assert bool(torch.isfinite(out).all())
    assert info["weights"].shape == (4,)


def test_stacked_layout_matches_flat_layout():
    """tests/test_system.py::test_stacked_layout_matches_flat_layout: the
    stacked route reaches the flat layout's consensus (weights, output)."""
    wcfg = twf.WFAggConfig(f=1, use_temporal=False)
    g = torch.Generator().manual_seed(1)
    grads = {"a": torch.randn((4, 32, 8), generator=g), "b": torch.randn((4, 100), generator=g)}
    flat = torch.cat([grads["a"].reshape(4, -1), grads["b"]], dim=1)
    cfg = tra.RobustAggConfig(method="wfagg", wfagg=wcfg, chunk_size=64)
    out_f, _, info_f = tra.robust_allreduce(flat, tra.Emulated(4), cfg, None)
    out_s, _, info_s = tra.robust_allreduce_stacked(
        grads, tra.RobustAggConfig(method="wfagg", wfagg=wcfg, layout="stacked"), None)
    torch.testing.assert_close(info_f["weights"], info_s["weights"], atol=1e-6, rtol=0)
    torch.testing.assert_close(out_f[:256].reshape(32, 8), out_s["a"], rtol=2e-5, atol=1e-6)
    torch.testing.assert_close(out_f[256:], out_s["b"], rtol=2e-5, atol=1e-6)


def test_axis_helpers():
    assert tra.axis_size(tra.Emulated(5)) == 5
    assert torch.equal(tra.my_index(tra.Emulated(3)), torch.arange(3))
    torch.testing.assert_close(tra.pmean(torch.tensor([1.0, 2.0, 6.0]), tra.Emulated(3)),
                               torch.tensor(3.0))
    chunks = list(tra._pad_chunks(torch.arange(10.0), 4))
    assert [c for c, _ in chunks] == [0, 1, 2]
    assert torch.equal(chunks[-1][1], torch.tensor([8.0, 9.0, 0.0, 0.0]))
