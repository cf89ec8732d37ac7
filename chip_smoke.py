#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs on
an NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; exits non-zero (and
prints no result) without them or outside a checkout of the repository.
Phases, each of which fails the run:

  1. the card's name and power limit; build the six kernel libraries of
     the port from the sources in the checkout, one ``nvcc`` each, all
     started together (timed; ptxas registers and spills printed);
  2. hold each kernel against its plain PyTorch version on the card:
     - the gossip round (``wfagg_round.cu``) at the paper's round shape
       (N=20, K=8, d=44,426) and on irregular slates with a degree-0 row
       at K=16 and K=32 (masks bit-equal, ``out`` within 3e-5);
     - the single-matrix statistics (``robust_stats.cu``) at the CFL
       server's shape (K=20, d=44,426, two bit-identical rows) with and
       without ``prev`` and the centers, and at K=7 and K=32 (median
       bit-equal, trimmed mean within rtol 1e-5, statistics within rtol
       1e-4 / atol 1e-3, WFAgg-D/C masks bit-equal, identical rows with
       identical sums);
     - the Gram (``pairwise_gram.cu``) at K=20 and K=32 (within rtol 1e-4,
       exactly symmetric, Multi-Krum and Clustering masks bit-equal);
     - the combine (``weighted_agg.cu``) within 3e-5, and exactly ``local``
       with all-zero weights;
     - the round kernel's Gram variant (Alt-WFAgg) on the paper's ring and
       on irregular slates with a degree-0 row at K=8/16/32, each with two
       bit-identical rows: masks and weights equal to
       ``derive_trust_weights`` of the kernel's own statistics and Gram and
       bit-equal to the plain version, the Gram exactly symmetric and within
       rtol 1e-4, ``out`` within 3e-5;
     - the gather-free statistics (``robust_stats_indexed.cu``) on the same
       slates with and without ``prev`` and the Gram (within rtol 1e-4,
       Gram exactly symmetric, identical rows tied, masks bit-equal) and
       the gather-free combine (``weighted_agg_indexed.cu``: within 1e-6 of
       the output's scale, exactly ``local`` with zero weights and on a
       degree-0 row);
     then time each kernel, its plain version, its bound and, where one
     PyTorch call computes the same function, that call, with CUDA
     events: the round at N=64, K=16, d=2^20; the CFL kernels at the CFL
     shape and at K=32, D=2^22 (512 MiB per matrix); the Gram round and
     the two-launch kernels at the paper's shape and at N=64, K=16,
     d=2^20; the Gram variant's cost by difference at N=64, K=32, d=8192;
     and the gossip aggregation on ``fused`` against ``fused_two_launch``
     at N=64, K=16, d=2^20;
  3. the main paths, each with every kernel's launch count set to 0 just
     before and read just after:
     - DFL: ``run_experiment`` at the paper's configuration (LeNet-5,
       20-node 8-regular ring, 2 Byzantine nodes placed close, IPM-100,
       6 rounds): WFAgg and Alt-WFAgg on the single-launch backend (one
       round-kernel launch per round), Alt-WFAgg and WFAgg on the
       two-launch backend (one statistics and one combine launch per
       round), the mean baseline beside them, each replayed round by
       round against the reference backend on the card, and the paper's
       IPM-100 claim (WFAgg and Alt-WFAgg each > 0.9 and > mean + 0.2;
       Multi-Krum and Clustering printed beside them) on the MLP;
     - CFL (``centralized=True``, the same topology and attack): WFAgg
       (one statistics and one combine launch per round, no Gram) and
       Alt-WFAgg (one of each of the three), each replayed round by round
       against the reference backend on the card, and the centralized
       IPM-100 claim (WFAgg and Alt-WFAgg each > mean + 0.2) on the MLP.

Prints the kernels' JSON line, then ``{"ok": true, "device": ...}`` last.
"""
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
OUT_TOL = 3e-5                   # tests/test_one_launch.py:20
STAT_RTOL, STAT_ATOL = 1e-4, 1e-3   # statistics: sums in another order
CFL_K, CFL_D = 20, 44426         # the CFL server: N = 20 LeNet-5 models
BIG_K, BIG_D = 32, 1 << 22       # 512 MiB per (K, D) matrix
ROUNDS = 6

# name -> (kernel module, counter attribute, source, the Pallas launch it replaces)
KERNELS = {
    "wfagg_round_indexed": ("repro_torch.kernels.robust_stats.kernel", "launches",
                            "src/repro_torch/kernels/robust_stats/csrc/wfagg_round.cu",
                            "src/repro/kernels/robust_stats/kernel.py:511"),
    "robust_stats": ("repro_torch.kernels.robust_stats.kernel", "robust_stats_launches",
                     "src/repro_torch/kernels/robust_stats/csrc/robust_stats.cu",
                     "src/repro/kernels/robust_stats/kernel.py:136"),
    "pairwise_gram": ("repro_torch.kernels.pairwise_dist.kernel", "launches",
                      "src/repro_torch/kernels/pairwise_dist/csrc/pairwise_gram.cu",
                      "src/repro/kernels/pairwise_dist/kernel.py:29"),
    "weighted_agg": ("repro_torch.kernels.weighted_agg.kernel", "launches",
                     "src/repro_torch/kernels/weighted_agg/csrc/weighted_agg.cu",
                     "src/repro/kernels/weighted_agg/kernel.py:88"),
    "robust_stats_indexed": ("repro_torch.kernels.robust_stats.kernel", "indexed_launches",
                             "src/repro_torch/kernels/robust_stats/csrc/"
                             "robust_stats_indexed.cu",
                             "src/repro/kernels/robust_stats/kernel.py:271"),
    "weighted_agg_indexed": ("repro_torch.kernels.weighted_agg.kernel", "indexed_launches",
                             "src/repro_torch/kernels/weighted_agg/csrc/"
                             "weighted_agg_indexed.cu",
                             "src/repro/kernels/weighted_agg/kernel.py:56"),
}


def _module(name):
    import importlib
    return importlib.import_module(KERNELS[name][0])


def zero_counts() -> None:
    for name, (_, attr, _, _) in KERNELS.items():
        setattr(_module(name), attr, 0)


def read_counts() -> dict:
    return {name: getattr(_module(name), attr) for name, (_, attr, _, _) in KERNELS.items()}


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernel vs plain
# ---------------------------------------------------------------------------

def irregular_slate(N, K, seed):
    """Padded (idx, valid) with per-node degrees in [1, K], padded slots
    pointing at the node itself, and node 1's slate empty (degree 0)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    idx = np.repeat(np.arange(N, dtype=np.int32)[:, None], K, axis=1)
    valid = np.zeros((N, K), bool)
    for n in range(N):
        v = 0 if n == 1 else int(rng.integers(1, K + 1))
        idx[n, :v] = rng.choice([i for i in range(N) if i != n], size=v, replace=False)
        valid[n, :v] = True
    return idx, valid


def round_inputs(torch, N, K, d, idx, valid, seed, dup=None):
    """Models, prev and bands on the card; bands built around this
    round's own temporal metrics so the WFAgg-T test accepts some edges
    and rejects others.  ``dup`` makes two rows bit-identical (two
    attackers sending one model)."""
    from repro_torch.core import trust
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    g = torch.Generator(device="cuda").manual_seed(seed)
    models = torch.randn((N, d), generator=g, device="cuda") + 0.3
    prev = models + 0.2 * torch.randn((N, d), generator=g, device="cuda")
    if dup is not None:
        models[dup[1]] = models[dup[0]] = -100.0 * models.mean(0)
    idx_t = torch.as_tensor(idx, device="cuda")
    valid_t = None if valid is None else torch.as_tensor(valid, device="cuda")
    cfg = WFAggConfig(transient=3)
    st = robust_stats_indexed_ref(models, idx_t, valid_t, prev)
    jitter = lambda x: x[:, None, :] * (1 + 0.05 * torch.randn(  # noqa: E731
        (N, cfg.window, K), generator=g, device="cuda"))
    tbands = trust.temporal_bands(
        jitter(st.prev_dist2), jitter(st.cosine_to_prev()),
        torch.full((N,), 3, device="cuda"), torch.full((N,), 5, device="cuda"), cfg)
    return models, prev, idx_t, valid_t, tbands, cfg


def compare_kernel(torch, label, N, K, d, idx, valid, seed, dup=None) -> float:
    from repro_torch.kernels.robust_stats import ops

    models, prev, idx_t, valid_t, tbands, cfg = round_inputs(
        torch, N, K, d, idx, valid, seed, dup)
    got = ops.wfagg_round_indexed(models, models, idx_t, valid_t, cfg,
                                  prev=prev, tbands=tbands)
    v = (torch.ones((N, K), dtype=torch.bool, device="cuda") if valid_t is None
         else valid_t)
    want = ops.wfagg_round_indexed_plain(models, models, idx_t, v, cfg, prev, tbands)
    torch.cuda.synchronize()
    for name, g, w in zip(("mask_d", "mask_c", "mask_t"), got[2:5], want[2:5]):
        if not torch.equal(g, w):
            raise AssertionError(f"{label}: {name} differs from the plain version "
                                 f"at {int((g != w).sum())} edges")
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[0], want[0], rtol=OUT_TOL, atol=OUT_TOL)
    for name in ("dist2", "dotmed", "norm2", "mednorm2", "prev_dist2",
                 "prev_dot", "prev_norm2"):
        torch.testing.assert_close(getattr(got[5], name), getattr(want[5], name),
                                   rtol=1e-4, atol=1e-3)
    if dup is not None:
        # bit-identical rows got bit-identical statistics
        a, b = (idx_t == dup[0]), (idx_t == dup[1])
        both = a.any(1) & b.any(1)
        da = torch.where(a, got[5].dist2, 0).sum(1)[both]
        db = torch.where(b, got[5].dist2, 0).sum(1)[both]
        if not torch.equal(da, db):
            raise AssertionError(f"{label}: identical rows got different dist2")
    err = float((got[0] - want[0]).abs().max())
    mask_t_on = int(got[4].sum())
    print(f"  {label}: masks bit-equal (mask_t on {mask_t_on} of {int(v.sum())} "
          f"edges), out max|err| {err:.3g}")
    if mask_t_on == 0:
        raise AssertionError(f"{label}: the temporal band test never fired")
    return err


def time_cuda(torch, fn, warmup, reps) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, each between its
    own pair of CUDA events, after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def time_round(torch, N, K, d, seed):
    """Kernel and plain times at one shape, with the kernel's bound."""
    from repro_torch.kernels.robust_stats import ops

    idx = [[(n + o) % N for o in range(1, K + 1)] for n in range(N)]
    models, prev, idx_t, _, tbands, cfg = round_inputs(torch, N, K, d, idx, None, seed)
    local = models.clone()
    v = torch.ones((N, K), dtype=torch.bool, device="cuda")
    ms = time_cuda(torch, lambda: ops.wfagg_round_indexed(
        local, models, idx_t, None, cfg, prev=prev, tbands=tbands), 3, 25)
    plain_ms = time_cuda(torch, lambda: ops.wfagg_round_indexed_plain(
        local, models, idx_t, v, cfg, prev, tbands), 1, 5)
    # least work: read models, prev, local once and write out once; about
    # 16 flops per candidate coordinate (six statistics and the combine),
    # not counting the median's comparisons
    byte_ms = 4.0 * (models.numel() + prev.numel() + local.numel() + N * d) \
        / HBM_BYTES_PER_S * 1e3
    op_ms = 16.0 * N * K * d / FP32_OPS_PER_S * 1e3
    return ms, plain_ms, max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms else "operations")


# ---------------------------------------------------------------------------
# phase 2: the single-matrix kernels of the CFL server
# ---------------------------------------------------------------------------

def cfl_candidates(torch, K, D, seed):
    """A CFL server's inputs on the card: K benign models near a common one,
    two attacker rows (0 and ``dup``) holding one bit-identical model, and
    each row's previous-round model (identical for the two attackers)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.randn((D,), generator=g, device="cuda")
    u = base + 0.1 * torch.randn((K, D), generator=g, device="cuda")
    prev = u + 0.05 * torch.randn((K, D), generator=g, device="cuda")
    dup = max(1, K // 5)
    u[0] = u[dup] = -3.0 * base
    prev[dup] = prev[0]
    return u, prev, dup


def compare_robust_stats(torch, K, D, seed, with_prev, need_center) -> float:
    from repro_torch.core import trust
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats import ops

    u, prev, dup = cfl_candidates(torch, K, D, seed)
    p = prev if with_prev else None
    got = ops.robust_stats(u, p, need_center=need_center)
    want = ops.robust_stats_plain(u, p, need_center=need_center)
    torch.cuda.synchronize()
    label = f"robust_stats K={K} D={D} prev={with_prev} centers={need_center}"
    errs = []
    if need_center:
        if not torch.equal(got.med, want.med):
            raise AssertionError(f"{label}: median differs from the plain version")
        torch.testing.assert_close(got.trim, want.trim, rtol=1e-5, atol=1e-6)
        errs.append(float((got.trim - want.trim).abs().max()))
    elif got.med is not None or got.trim is not None:
        raise AssertionError(f"{label}: centers returned without need_center")
    for name in ("dist2", "dotmed", "norm2", "mednorm2") + (
            ("prev_dist2", "prev_dot", "prev_norm2") if with_prev else ()):
        g, w = getattr(got, name), getattr(want, name)
        torch.testing.assert_close(g, w, rtol=STAT_RTOL, atol=STAT_ATOL)
        errs.append(float((g - w).abs().max()))
        if g.ndim and not torch.equal(g[0], g[dup]):
            raise AssertionError(f"{label}: identical rows got different {name}")
    cfg = WFAggConfig()
    for fn in (trust.fused_distance_mask, trust.fused_similarity_mask):
        if not torch.equal(fn(got, None, cfg), fn(want, None, cfg)):
            raise AssertionError(f"{label}: {fn.__name__} differs from the plain version")
    print(f"  {label}: median bit-equal, masks bit-equal, identical rows tied, "
          f"max|err| {max(errs):.3g}")
    return max(errs)


def compare_gram(torch, K, D, seed) -> float:
    from repro_torch.core import trust
    from repro_torch.core.wfagg import alt_wfagg_config
    from repro_torch.kernels.pairwise_dist import ops
    from repro_torch.kernels.robust_stats.ops import robust_stats_plain

    u, _, dup = cfl_candidates(torch, K, D, seed)
    gram, norm2 = ops.pairwise_gram(u)
    gp, np_ = ops.pairwise_gram_plain(u)
    torch.cuda.synchronize()
    label = f"pairwise_gram K={K} D={D}"
    # sums of D products of order 1: atol scales with D
    torch.testing.assert_close(gram, gp, rtol=1e-4, atol=1e-6 * D)
    torch.testing.assert_close(norm2, np_, rtol=1e-4, atol=1e-6 * D)
    if not torch.equal(gram, gram.T):
        raise AssertionError(f"{label}: Gram not exactly symmetric")
    others = [j for j in range(K) if j not in (0, dup)]
    if not torch.equal(gram[0, others], gram[dup, others]):
        raise AssertionError(f"{label}: identical rows got different Gram rows")
    stats = robust_stats_plain(u, need_center=False)
    cfg = alt_wfagg_config(multi_krum_m=max(1, int(0.25 * K)))
    for fn in (trust.fused_distance_mask, trust.fused_similarity_mask):
        if not torch.equal(fn(stats, gram, cfg), fn(stats, gp, cfg)):
            raise AssertionError(f"{label}: {fn.__name__} differs with the plain Gram")
    err = float((gram - gp).abs().max())
    print(f"  {label}: symmetric, Multi-Krum and Clustering masks bit-equal, "
          f"identical rows tied, max|err| {err:.3g}")
    return err


def compare_weighted_agg(torch, K, D, seed) -> float:
    from repro_torch.core.trust import combine_coefficients
    from repro_torch.kernels.weighted_agg import ops

    u, _, dup = cfl_candidates(torch, K, D, seed)
    local = u[1:].mean(0)
    w = torch.where(torch.arange(K, device="cuda") % 3 == 0, 0.6, 0.8)
    w[0] = w[dup] = 0.0
    got = ops.weighted_agg(local, u, w, alpha=0.8)
    want = ops.weighted_agg_plain(*combine_coefficients(w, 0.8), local, u)
    zero = ops.weighted_agg(local, u, torch.zeros_like(w), alpha=0.8)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=OUT_TOL, atol=OUT_TOL)
    if not torch.equal(zero, local):
        raise AssertionError(f"weighted_agg K={K}: all-zero weights did not keep local")
    err = float((got - want).abs().max())
    print(f"  weighted_agg K={K} D={D}: within {OUT_TOL}, zero weights give local "
          f"exactly, max|err| {err:.3g}")
    return err


# ---------------------------------------------------------------------------
# phase 2: the Gram round and the two-launch kernels of the gossip round
# ---------------------------------------------------------------------------

def alt_config(K):
    """Alt-WFAgg at candidate count K as the DFL engine configures it
    (Multi-Krum m = max(1, int(0.25 K)), Clustering), with the bands of
    ``round_inputs``."""
    from repro_torch.core.wfagg import alt_wfagg_config

    return alt_wfagg_config(transient=3, multi_krum_m=max(1, int(0.25 * K)))


def tied_nodes(torch, idx_t, valid_t, dup):
    """Nodes whose valid slate holds both bit-identical rows (their
    previous-round rows differ), and the two slots of each."""
    v = (torch.ones(idx_t.shape, dtype=torch.bool, device=idx_t.device)
         if valid_t is None else valid_t)
    a, b = (idx_t == dup[0]) & v, (idx_t == dup[1]) & v
    both = torch.nonzero(a.any(1) & b.any(1)).flatten()
    return [(int(n), int(a[n].nonzero()[0]), int(b[n].nonzero()[0])) for n in both]


def check_ties(torch, label, stats, ties, fields):
    """Identical rows got bit-identical statistics and Gram rows."""
    for n, ka, kb in ties:
        for name in fields:
            x = getattr(stats, name)
            if x is not None and not torch.equal(x[n, ka], x[n, kb]):
                raise AssertionError(f"{label}: identical rows got different {name}")
        if stats.gram is not None:
            g = stats.gram[n]
            others = [j for j in range(g.shape[0]) if j not in (ka, kb)]
            if not (torch.equal(g[ka, others], g[kb, others])
                    and torch.equal(g[ka, ka], g[kb, kb])):
                raise AssertionError(f"{label}: identical rows got different Gram rows")


def compare_gram_round(torch, label, N, K, d, idx, valid, seed, dup) -> float:
    """The round kernel's Gram variant (Alt-WFAgg) against its plain
    version, and its epilogue against ``derive_trust_weights`` of its own
    statistics and Gram."""
    from repro_torch.core import trust
    from repro_torch.kernels.robust_stats import ops

    models, prev, idx_t, valid_t, tbands, _ = round_inputs(
        torch, N, K, d, idx, valid, seed, dup)
    cfg = alt_config(K)
    got = ops.wfagg_round_indexed(models, models, idx_t, valid_t, cfg,
                                  prev=prev, tbands=tbands)
    v = (torch.ones((N, K), dtype=torch.bool, device="cuda") if valid_t is None
         else valid_t)
    want = ops.wfagg_round_indexed_plain(models, models, idx_t, v, cfg, prev, tbands)
    own = trust.derive_trust_weights(got[5], v, tbands, cfg)
    torch.cuda.synchronize()
    for name, g, w, o in zip(("mask_d", "mask_c", "mask_t"), got[2:5], want[2:5], own):
        if not torch.equal(g, o):
            raise AssertionError(f"{label}: the epilogue's {name} differs from "
                                 f"derive_trust_weights of its own stats at "
                                 f"{int((g != o).sum())} edges")
        if not torch.equal(g, w):
            raise AssertionError(f"{label}: {name} differs from the plain version "
                                 f"at {int((g != w).sum())} edges")
    if not torch.equal(got[1], own[3]):
        raise AssertionError(f"{label}: the epilogue's weights differ from "
                             "derive_trust_weights of its own stats")
    gram, gp = got[5].gram, want[5].gram
    if not torch.equal(gram, gram.transpose(1, 2)):
        raise AssertionError(f"{label}: Gram not exactly symmetric")
    torch.testing.assert_close(gram, gp, rtol=1e-4, atol=1e-6 * d)
    torch.testing.assert_close(got[0], want[0], rtol=OUT_TOL, atol=OUT_TOL)
    for name in ("dist2", "dotmed", "norm2", "mednorm2", "prev_dist2",
                 "prev_dot", "prev_norm2"):
        torch.testing.assert_close(getattr(got[5], name), getattr(want[5], name),
                                   rtol=STAT_RTOL, atol=STAT_ATOL)
    ties = tied_nodes(torch, idx_t, valid_t, dup)
    check_ties(torch, label, got[5], ties, ("dist2", "dotmed", "norm2"))
    err = float((got[0] - want[0]).abs().max())
    print(f"  {label}: masks bit-equal to the plain version and to "
          f"derive_trust_weights of the kernel's own stats and Gram (mask_d on "
          f"{int(got[2].sum())}, mask_c on {int(got[3].sum())}, mask_t on "
          f"{int(got[4].sum())} of {int(v.sum())} edges); Gram symmetric, max|err| "
          f"{float((gram - gp).abs().max()):.3g}; {len(ties)} nodes with the tied "
          f"rows; out max|err| {err:.3g}")
    return err


def compare_indexed_stats(torch, label, N, K, d, idx, valid, seed, dup,
                          with_prev, need_gram) -> float:
    """Kernel 2 against ``ref.robust_stats_indexed_ref``: statistics within
    rtol 1e-4, Gram exactly symmetric, identical rows tied, and the masks
    from its statistics bit-equal to those from the plain statistics."""
    from repro_torch.core import trust
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats import ops
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    models, prev, idx_t, valid_t, _, _ = round_inputs(torch, N, K, d, idx, valid,
                                                      seed, dup)
    p = prev if with_prev else None
    got = ops.robust_stats_indexed(models, idx_t, valid_t, p, need_gram=need_gram)
    v = (torch.ones((N, K), dtype=torch.bool, device="cuda") if valid_t is None
         else valid_t)
    want = robust_stats_indexed_ref(models, idx_t, v, p, need_gram=need_gram)
    torch.cuda.synchronize()
    label = f"{label} prev={with_prev} gram={need_gram}"
    fields = ("dist2", "dotmed", "norm2", "mednorm2") + (
        ("prev_dist2", "prev_dot", "prev_norm2") if with_prev else ())
    errs = []
    for name in fields:
        g, w = getattr(got, name), getattr(want, name)
        torch.testing.assert_close(g, w, rtol=STAT_RTOL, atol=STAT_ATOL)
        errs.append(float((g - w).abs().max()))
    if not with_prev and got.prev_dist2 is not None:
        raise AssertionError(f"{label}: a temporal tail without prev")
    if need_gram:
        if not torch.equal(got.gram, got.gram.transpose(1, 2)):
            raise AssertionError(f"{label}: Gram not exactly symmetric")
        torch.testing.assert_close(got.gram, want.gram, rtol=1e-4, atol=1e-6 * d)
        errs.append(float((got.gram - want.gram).abs().max()))
    elif got.gram is not None:
        raise AssertionError(f"{label}: a Gram without need_gram")
    ties = tied_nodes(torch, idx_t, valid_t, dup)
    check_ties(torch, label, got, ties, fields[:3])
    cfgs = [WFAggConfig()] + ([alt_config(K)] if need_gram else [])
    for cfg in cfgs:
        mk = lambda st: trust.derive_trust_weights(st, v, None, cfg)[:2]  # noqa: E731
        for g, w in zip(mk(got), mk(want)):
            if not torch.equal(g, w):
                raise AssertionError(f"{label}: masks from the kernel's statistics "
                                     f"differ from the plain ones ({cfg.distance_filter})")
    print(f"  {label}: statistics within rtol {STAT_RTOL}, masks bit-equal, "
          f"{len(ties)} nodes with the tied rows tied, max|err| {max(errs):.3g}")
    return max(errs)


def compare_weighted_agg_indexed(torch, label, N, K, d, idx, valid, seed) -> float:
    """Kernel 3 against its plain version (within 1e-6 of the output's
    scale), exactly ``local`` with zero weights, and a degree-0 row keeps
    its local model."""
    from repro_torch.core.trust import combine_coefficients
    from repro_torch.kernels.weighted_agg import ops

    g = torch.Generator(device="cuda").manual_seed(seed)
    models = torch.randn((N, d), generator=g, device="cuda") + 0.3
    local = torch.randn((N, d), generator=g, device="cuda")
    idx_t = torch.as_tensor(idx, device="cuda")
    v = (torch.ones((N, K), dtype=torch.bool, device="cuda") if valid is None
         else torch.as_tensor(valid, device="cuda"))
    w = torch.where(torch.rand((N, K), generator=g, device="cuda") < 0.3, 0.0, 0.8)
    w = torch.where(v, w, 0.0)
    got = ops.weighted_agg_indexed(local, models, idx_t, w, alpha=0.8)
    want = ops.weighted_agg_indexed_plain(*combine_coefficients(w, 0.8), local, models,
                                          idx_t)
    zero = ops.weighted_agg_indexed(local, models, idx_t, torch.zeros_like(w), alpha=0.8)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if err > 1e-6 * scale:
        raise AssertionError(f"{label}: weighted_agg_indexed off its plain version by "
                             f"{err:.3g} (scale {scale:.3g})")
    if not torch.equal(zero, local):
        raise AssertionError(f"{label}: all-zero weights did not keep local")
    deg0 = ~v.any(1)
    if not torch.equal(got[deg0], local[deg0]):
        raise AssertionError(f"{label}: a degree-0 row did not keep its local model")
    print(f"  {label}: within 1e-6 of scale {scale:.3g} (max|err| {err:.3g}), zero "
          f"weights give local exactly, {int(deg0.sum())} degree-0 rows keep local")
    return err


def time_dfl_kernels(torch, N, K, d, seed) -> dict:
    """The round kernel's Gram variant, kernel 2 (with Gram and prev) and
    kernel 3 through their ``*_cuda`` wrappers on a ring slate, their
    plain versions, bounds and, for kernel 3, the library calls.  Returns
    name -> {ms, plain_ms, bound_ms, bound_by, library_ms}."""
    from repro_torch.core.trust import combine_coefficients
    from repro_torch.kernels.common import pad_d
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats import ops as rops
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref
    from repro_torch.kernels.weighted_agg import kernel as wk
    from repro_torch.kernels.weighted_agg import ops as wops

    idx = [[(n + o) % N for o in range(1, K + 1)] for n in range(N)]
    models, prev, idx_t, _, tbands, _ = round_inputs(torch, N, K, d, idx, None, seed)
    cfg = alt_config(K)
    local = models.clone()
    v = torch.ones((N, K), dtype=torch.bool, device="cuda")
    i32 = idx_t.to(torch.int32)
    out = {}
    # statistics (16 flops per candidate coordinate, as for the round) and
    # the Gram's K(K+1) per node coordinate
    n_ops = (16.0 * K + K * (K + 1.0)) * N * d
    b = bound(4.0 * (3 * N * d + N * d), n_ops)   # models, prev, local, out
    out["wfagg_round_indexed_gram"] = dict(
        ms=time_cuda(torch, lambda: rk.wfagg_round_indexed_cuda(
            local, models, i32, v, prev, tbands, cfg, cfg.alpha, False), 3, 25),
        plain_ms=time_cuda(torch, lambda: rops.wfagg_round_indexed_plain(
            local, models, idx_t, v, cfg, prev, tbands), 1, 5),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    b = bound(4.0 * 2 * N * d, n_ops)             # models and prev once
    no_gram = time_cuda(torch, lambda: rk.robust_stats_indexed_cuda(
        models, i32, v, prev, False), 3, 25)
    print(f"  robust_stats_indexed N={N} K={K} d={d} with prev, without the Gram: "
          f"kernel {no_gram:.4f} ms")
    out["robust_stats_indexed"] = dict(
        ms=time_cuda(torch, lambda: rk.robust_stats_indexed_cuda(
            models, i32, v, prev, True), 3, 25),
        plain_ms=time_cuda(torch, lambda: robust_stats_indexed_ref(
            models, idx_t, v, prev, need_gram=True), 1, 5),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    # every node accepts someone, so lcoef is one number (beta of baddbmm)
    w = torch.where(torch.arange(K, device="cuda") % 3 == 0, 0.6, 0.8).expand(N, K)
    wvec, lcoef = combine_coefficients(w.contiguous(), 0.8)
    lc = float(lcoef[0])
    b = bound(4.0 * 3 * N * d, 2.0 * N * K * d)  # models, local, out
    l4, m4 = pad_d(local, 4).contiguous(), pad_d(models, 4).contiguous()
    out["weighted_agg_indexed"] = dict(
        ms=time_cuda(torch, lambda: wk.weighted_agg_indexed_cuda(
            wvec, lcoef, l4, m4, i32), 3, 25),
        plain_ms=time_cuda(torch, lambda: wops.weighted_agg_indexed_plain(
            wvec, lcoef, local, models, idx_t), 1, 5),
        bound_ms=b[0], bound_by=b[1],
        # two calls: the gather, then one batched matrix product
        library_ms=time_cuda(torch, lambda: torch.baddbmm(
            local[:, None], wvec[:, None], models[idx_t], beta=lc), 3, 25))
    for name, t in out.items():
        lib = ("none" if t["library_ms"] is None
               else f"{t['library_ms']:.4f} ms (models[idx] + torch.baddbmm)")
        print(f"  {name} N={N} K={K} d={d}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
              f"({t['bound_by']}), library {lib}")
    return out


def time_gram_epilogue(torch, N, K, d, seed) -> None:
    """What the Gram variant costs in the round kernel, by difference at a
    short d where the epilogue shows: WFAgg (no Gram), Multi-Krum + WFAgg-C
    (the Gram and the Krum scores) and Alt-WFAgg (also the Clustering
    loop's K - 2 merge steps)."""
    import dataclasses

    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats import kernel as rk

    idx = [[(n + o) % N for o in range(1, K + 1)] for n in range(N)]
    models, prev, idx_t, _, tbands, _ = round_inputs(torch, N, K, d, idx, None, seed)
    v = torch.ones((N, K), dtype=torch.bool, device="cuda")
    i32 = idx_t.to(torch.int32)
    alt = alt_config(K)
    ms = {}
    for name, cfg in (("wfagg", WFAggConfig(transient=3)),
                      ("multi_krum+wfagg_c", dataclasses.replace(
                          alt, similarity_filter="wfagg_c")),
                      ("alt_wfagg", alt)):
        ms[name] = time_cuda(torch, lambda: rk.wfagg_round_indexed_cuda(
            models, models, i32, v, prev, tbands, cfg, cfg.alpha, False), 3, 25)
    print(f"  round kernel N={N} K={K} d={d}: " + ", ".join(
        f"{k} {t:.4f} ms" for k, t in ms.items()) + " (the Gram and Krum: "
        f"{ms['multi_krum+wfagg_c'] - ms['wfagg']:.4f} ms, the Clustering loop: "
        f"{ms['alt_wfagg'] - ms['multi_krum+wfagg_c']:.4f} ms)")


def time_dfl_backends(torch, N, K, d, seed) -> None:
    """The gossip round's aggregation (``wfagg_batch``, host work included)
    on ``fused`` (one launch) against ``fused_two_launch`` (two launches
    and the host scoring stage), for WFAgg and Alt-WFAgg, on a ring slate
    with live temporal state; in turns: fused, two-launch, two-launch,
    fused."""
    import dataclasses

    from repro_torch.core import wfagg as wf

    idx = [[(n + o) % N for o in range(1, K + 1)] for n in range(N)]
    models, prev, idx_t, _, _, _ = round_inputs(torch, N, K, d, idx, None, seed)
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    hist = lambda: 1 + 0.1 * torch.rand((N, 3, K), generator=g, device="cuda")  # noqa: E731
    state = wf.TemporalState(prev=prev, hist_s=hist(), hist_b=hist(),
                             count=torch.full((N,), 3, dtype=torch.int32, device="cuda"),
                             t=torch.full((N,), 5, dtype=torch.int32, device="cuda"))
    for name, base in (("wfagg", wf.WFAggConfig()), ("alt_wfagg", alt_config(K))):
        ms = {}
        for backend in ("fused", "fused_two_launch", "fused_two_launch", "fused"):
            cfg = dataclasses.replace(base, backend=backend)
            ms.setdefault(backend, []).append(time_cuda(torch, lambda: wf.wfagg_batch(
                models, models, state, cfg, neighbor_idx=idx_t), 2, 10))
        print(f"  {name} aggregation N={N} K={K} d={d} (wfagg_batch, median ms of "
              f"10, two turns each): fused {ms['fused']}, fused_two_launch "
              f"{ms['fused_two_launch']}")


def network_compare_exchanges(K: int) -> int:
    """Compare-exchanges of robust_stats.cu's bitonic network for K padded
    to 8, 16 or 32."""
    kp = 8 if K <= 8 else 16 if K <= 16 else 32
    lg = kp.bit_length() - 1
    return kp // 2 * lg * (lg + 1) // 2


def bound(nbytes: float, ops: float):
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / FP32_OPS_PER_S * 1e3
    return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms else "operations")


def time_cfl_kernels(torch, K, D, seed) -> dict:
    """Each single-matrix kernel's wrapper (``*_cuda``, the call that
    launches it) as the CFL server calls it, its plain version, its bound
    and, where one exists, the one PyTorch call that computes the same
    function.  Returns name -> {ms, plain_ms, bound_ms, bound_by,
    library_ms}."""
    from repro_torch.core.trust import combine_coefficients
    from repro_torch.kernels.common import pad_d
    from repro_torch.kernels.pairwise_dist import kernel as pk
    from repro_torch.kernels.pairwise_dist import ops as pops
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats import ops as rops
    from repro_torch.kernels.weighted_agg import kernel as wk
    from repro_torch.kernels.weighted_agg import ops as wops

    u, prev, dup = cfl_candidates(torch, K, D, seed)
    out = {}
    # statistics with the temporal tail and no centers (the main path's
    # call): read u and prev once; 2 ops per compare-exchange, 8 flops per
    # candidate coordinate for dist2 / dotmed / norm2 and 7 for the tail
    b = bound(4.0 * 2 * K * D, D * (2.0 * network_compare_exchanges(K) + 15.0 * K))
    out["robust_stats"] = dict(
        ms=time_cuda(torch, lambda: rk.robust_stats_cuda(u, prev, 0.1, False), 3, 25),
        plain_ms=time_cuda(torch, lambda: rops.robust_stats_plain(
            u, prev, need_center=False), 1, 5),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    b = bound(4.0 * K * D, float(K * (K + 1)) * D)
    out["pairwise_gram"] = dict(
        ms=time_cuda(torch, lambda: pk.pairwise_gram_cuda(u), 3, 25),
        plain_ms=time_cuda(torch, lambda: pops.pairwise_gram_plain(u), 1, 5),
        bound_ms=b[0], bound_by=b[1],
        library_ms=time_cuda(torch, lambda: torch.mm(u, u.t()), 3, 25))
    w = torch.where(torch.arange(K, device="cuda") % 3 == 0, 0.6, 0.8)
    w[0] = w[dup] = 0.0
    wvec, lcoef = combine_coefficients(w, 0.8)
    lcoef = lcoef.reshape(1)
    local = u[1:].mean(0)
    u4, l4 = pad_d(u, 4).contiguous(), pad_d(local, 4).contiguous()
    lc = float(lcoef)
    b = bound(4.0 * (K + 2) * D, 2.0 * K * D)
    out["weighted_agg"] = dict(
        ms=time_cuda(torch, lambda: wk.weighted_agg_cuda(wvec, lcoef, l4, u4), 3, 25),
        plain_ms=time_cuda(torch, lambda: wops.weighted_agg_plain(
            wvec, lcoef, local, u), 1, 5),
        bound_ms=b[0], bound_by=b[1],
        library_ms=time_cuda(torch, lambda: torch.addmv(local, u.t(), wvec, beta=lc),
                             3, 25))
    # the ops-level wrappers as the main path calls them (coefficients, and
    # the row padding of the combine when D % 4 != 0)
    wrap = (time_cuda(torch, lambda: rops.robust_stats(u, prev, need_center=False), 3, 25),
            time_cuda(torch, lambda: pops.pairwise_gram(u), 3, 25),
            time_cuda(torch, lambda: wops.weighted_agg(local, u, w, alpha=0.8), 3, 25))
    for name, t in out.items():
        lib = ("none" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms")
        print(f"  {name} K={K} D={D}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
              f"library {lib}")
    print(f"  ops-level wrappers at K={K} D={D}: robust_stats {wrap[0]:.4f} ms, "
          f"pairwise_gram {wrap[1]:.4f} ms, weighted_agg {wrap[2]:.4f} ms")
    return out


# ---------------------------------------------------------------------------
# phase 3: the main paths
# ---------------------------------------------------------------------------

def check_against_reference(torch, cfg, topo, data, rounds, against="reference"):
    """Replay a DFL run round by round: from each of its states, one round
    on the run's backend and one on the ``against`` backend (deterministic
    cuDNN, so local training is identical) must give bit-equal verdicts and
    models within 3e-5.  A round whose verdicts differ only where a float32
    value sits within 1e-4 (relative) of a WFAgg-T band edge or of a
    distance filter's keep boundary is reported with the filter and the
    margin, and the replay goes on from the run's state; any other
    difference fails."""
    import dataclasses

    from repro_torch.dfl import engine
    from repro_torch.models.lenet import ravel

    ref_cfg = dataclasses.replace(cfg, wfagg_backend=against)
    fused = engine.build_round_fn(cfg, topo, data, telemetry=True)
    ref = engine.build_round_fn(ref_cfg, topo, data, telemetry=True)
    state = engine.init_dfl_state(cfg, topo)
    benign = torch.as_tensor(~topo.malicious, device="cuda")
    label = f"{cfg.aggregator} on {cfg.wfagg_backend}"
    vs = f"the {against} backend"
    torch.backends.cudnn.deterministic = True
    try:
        t_fired, nonfinite, edge_rounds = 0, [], []
        for r in range(rounds):
            nxt, rec = fused(state)
            alt, rec_ref = ref(state)
            flat = ravel(nxt.node_params)
            # an attacker's own model may go non-finite (the reference's
            # attack math carries it); every benign model must not
            finite = torch.isfinite(flat).all(1)
            if not finite[benign].all():
                raise AssertionError(f"{label} round {r + 1}: a benign model is not finite")
            nonfinite.append(torch.nonzero(~finite).flatten().tolist())
            if not torch.equal(rec.verdict, rec_ref.verdict):
                report = explain_dfl_round(torch, cfg, topo, data, state, rec, rec_ref)
                print(f"  {label} round {r + 1}: verdicts differ from {vs}: "
                      f"(node, slot, filter, margin) {report}")
                if not report or any(m is None or m > 1e-4 for _, _, _, m in report):
                    raise AssertionError(f"{label} round {r + 1}: verdicts differ from "
                                         f"{vs} away from any edge")
                edge_rounds.append((r + 1, report))
            else:
                torch.testing.assert_close(flat, ravel(alt.node_params), rtol=OUT_TOL,
                                           atol=OUT_TOL, equal_nan=True)
            t_fired += int(((rec.verdict >> 2) & 1).sum())
            state = nxt
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"  {label} == {vs} on the card, {rounds} rounds: verdicts "
          f"bit-equal and models within {OUT_TOL} in {rounds - len(edge_rounds)} rounds "
          f"(rounds on an edge: {edge_rounds}); WFAgg-T accepted {t_fired} edges; "
          f"non-finite (attacker) rows per round {nonfinite}")
    if t_fired == 0:
        raise AssertionError(f"{label}: the WFAgg-T band test never fired")
    return edge_rounds


def explain_dfl_round(torch, cfg, topo, data, state, rec, rec_ref):
    """On differing verdicts: for each differing (node, slot, filter), the
    relative margin by which the reference's own float32 value clears the
    decision: the nearest WFAgg-T band edge, or the gap between the last
    kept and the first dropped score of the distance filter; None where no
    margin is defined (the similarity filters)."""
    from repro_torch.core import aggregators as agg
    from repro_torch.core import trust
    from repro_torch.dfl import engine
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref
    from repro_torch.models.lenet import ravel

    mal = torch.as_tensor(topo.malicious, device="cuda")
    params, _ = engine._local_train(cfg, data, mal, state.node_params,
                                    state.node_momentum, state.rnd)
    flat = engine._apply_attacks(cfg, mal, ravel(params), state.rnd)
    finite = torch.isfinite(flat).all(-1)
    flat = torch.where(finite[:, None], flat, torch.zeros_like(flat))
    idx = torch.as_tensor(topo.neighbor_indices, device="cuda").long()
    v = finite[idx]
    K = idx.shape[1]
    wcfg = engine._wfagg_full_config(cfg, K)
    ts = state.temporal
    st = robust_stats_indexed_ref(flat, idx, v, ts.prev, need_gram=True)
    tb = trust.temporal_bands(ts.hist_s, ts.hist_b, ts.count, ts.t, wcfg)
    rel = lambda x, e: float(((x - e).abs() / x.abs().clamp(min=1e-30)).item())  # noqa: E731
    if wcfg.distance_filter == "multi_krum":
        d2 = trust.sq_dists_from_gram(st.gram, st.norm2)
        vp = v[:, :, None] & v[:, None, :]
        scores = agg.krum_scores_from_sq_dists_dyn(torch.where(vp, d2, torch.inf),
                                                   wcfg.f, v.sum(-1))
        keep = torch.clamp(v.sum(-1), max=trust.multi_krum_m(wcfg, K))
    else:
        scores, keep = st.dist2, v.sum(-1) - wcfg.f - 1
    scores = torch.where(v, scores, torch.inf)
    report = []
    for n, k in torch.nonzero(rec.verdict != rec_ref.verdict).tolist():
        diff = int(rec.verdict[n, k] ^ rec_ref.verdict[n, k])
        for bit, name in ((0, "distance"), (1, "similarity"), (2, "WFAgg-T")):
            if not (diff >> bit) & 1:
                continue
            margin = None
            if bit == 2:
                s_t, b_t = st.prev_dist2[n, k], st.cosine_to_prev()[n, k]
                margin = min(rel(s_t, tb[n, k]), rel(s_t, tb[n, K + k]),
                             rel(b_t, tb[n, 2 * K + k]), rel(b_t, tb[n, 3 * K + k]))
            elif bit == 0 and 0 < int(keep[n]) < int(v[n].sum()):
                srt = torch.sort(scores[n]).values
                margin = rel(srt[int(keep[n])], srt[int(keep[n]) - 1])
            report.append((n, k, name, margin))
    return report


def check_cfl_against_reference(torch, cfg, topo, data, rounds):
    """Replay a CFL run round by round: from each of its states, one fused
    and one reference round (deterministic cuDNN, so local training is
    identical) must give the same global model within 3e-5."""
    import dataclasses

    from repro_torch.dfl import engine
    from repro_torch.models.lenet import ravel

    fused = engine.build_round_fn(cfg, topo, data)
    ref = engine.build_round_fn(dataclasses.replace(cfg, wfagg_backend="reference"),
                                topo, data)
    state = engine.init_dfl_state(cfg, topo)
    torch.backends.cudnn.deterministic = True
    try:
        errs = []
        for r in range(rounds):
            nxt, alt = fused(state), ref(state)
            flat, want = ravel(nxt.node_params)[0], ravel(alt.node_params)[0]
            if not torch.isfinite(flat).all():
                raise AssertionError(f"{cfg.aggregator} round {r + 1}: global model "
                                     "not finite")
            err = float((flat - want).abs().max())
            if not torch.allclose(flat, want, rtol=OUT_TOL, atol=OUT_TOL):
                explain_cfl_round(torch, cfg, topo, data, state)
                raise AssertionError(f"{cfg.aggregator} round {r + 1}: fused and "
                                     f"reference global models differ by {err:.3g}")
            errs.append(err)
            state = nxt
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"  {cfg.aggregator}: fused == reference backend on the card, {rounds} "
          f"rounds, global model max|err| per round {[f'{e:.3g}' for e in errs]}")


def explain_cfl_round(torch, cfg, topo, data, state):
    """On a failed replay: the server's masks under both backends, from the
    same received models."""
    from repro_torch.core import wfagg as wf
    from repro_torch.dfl import engine
    from repro_torch.models.lenet import ravel

    mal = torch.as_tensor(topo.malicious, device="cuda")
    anchor = ravel({k: v[:1] for k, v in state.node_params.items()})[0]
    params, _ = engine._local_train(cfg, data, mal, state.node_params,
                                    state.node_momentum, state.rnd)
    flat = engine._apply_attacks(cfg, mal, ravel(params), state.rnd)
    t0 = wf.TemporalState(*(x[0] for x in state.temporal))
    for backend in ("fused", "reference"):
        wcfg = engine._wfagg_full_config(cfg, flat.shape[0], backend=backend)
        _, _, info = wf.wfagg(anchor, flat, t0, wcfg)
        print(f"    {backend:9s} " + " ".join(
            f"{m}={''.join(str(int(x)) for x in info[m].tolist())}"
            for m in ("mask_d", "mask_c", "mask_t")))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.core.topology import make_topology, paper_topology
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.dfl.engine import DFLConfig, run_experiment
    from repro_torch.kernels import common

    print(gpu_line())

    # ---- phase 1: build -----------------------------------------------------
    t0 = time.perf_counter()
    libs = common.build(*(ROOT / src for _, _, src, _ in KERNELS.values()))
    print(f"[1] built {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for so in libs:
        entry = ""
        for line in so.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]     # the mangled kernel and its template
            if "registers" in line or "spill" in line:
                print(f"    {so.name.rsplit('_', 1)[0]} {entry} ptxas: {line.strip()}")

    # ---- phase 2: kernel vs plain -------------------------------------------
    print("[2] kernel vs plain version on the card")
    topo = make_topology(20, 8, 2, "ring", placement="close")
    errs = {"wfagg_round_indexed": [compare_kernel(
        torch, "paper N=20 K=8 d=44426", 20, 8, 44426, topo.neighbor_indices, None,
        seed=1, dup=(0, 4))]}
    for N, K, d, seed in ((40, 16, 44426, 2), (48, 32, 20011, 3)):
        idx, valid = irregular_slate(N, K, seed)
        errs["wfagg_round_indexed"].append(compare_kernel(
            torch, f"irregular N={N} K={K} d={d} (degree 0)", N, K, d, idx, valid,
            seed=seed))
    errs["robust_stats"] = [
        compare_robust_stats(torch, CFL_K, CFL_D, 7, with_prev, centers)
        for with_prev in (False, True) for centers in (True, False)]
    errs["robust_stats"] += [compare_robust_stats(torch, K, d, 8, True, True)
                             for K, d in ((7, 20011), (32, 20011))]
    errs["pairwise_gram"] = [compare_gram(torch, K, CFL_D, 9) for K in (CFL_K, 32)]
    errs["weighted_agg"] = [compare_weighted_agg(torch, K, d, 10)
                            for K, d in ((CFL_K, CFL_D), (32, 20011))]
    paper = time_round(torch, 20, 8, 44426, seed=5)
    print(f"  paper shape N=20 K=8 d=44426: kernel {paper[0]:.4f} ms, plain "
          f"{paper[1]:.4f} ms, bound {paper[2]:.5f} ms ({paper[3]})")
    ms, plain_ms, bound_ms, bound_by = time_round(torch, 64, 16, 1 << 20, seed=6)
    print(f"  N=64 K=16 d=2^20: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}); no single PyTorch call computes "
          "this function, so there is no library time")
    timed = {"wfagg_round_indexed": dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                         bound_by=bound_by, library_ms=None)}
    time_cfl_kernels(torch, CFL_K, CFL_D, seed=11)
    timed.update(time_cfl_kernels(torch, BIG_K, BIG_D, seed=12))

    print("[2] the gossip round's Gram variant and the two-launch kernels vs plain")
    slates = [("paper ring N=20 K=8 d=44426", 20, 8, 44426, topo.neighbor_indices,
               None, 21)]
    for N, K, d, seed in ((20, 8, 44426, 22), (40, 16, 44426, 23), (48, 32, 20011, 24)):
        idx, valid = irregular_slate(N, K, seed)
        slates.append((f"irregular N={N} K={K} d={d} (degree 0)", N, K, d, idx, valid,
                       seed))
    errs["robust_stats_indexed"], errs["weighted_agg_indexed"] = [], []
    for label, N, K, d, idx, valid, seed in slates:
        errs["wfagg_round_indexed"].append(compare_gram_round(
            torch, f"Gram round {label}", N, K, d, idx, valid, seed, dup=(0, 4)))
        combos = (((False, False), (True, False), (False, True), (True, True))
                  if K == 8 else ((False, False), (True, True)))
        errs["robust_stats_indexed"] += [compare_indexed_stats(
            torch, f"robust_stats_indexed {label}", N, K, d, idx, valid, seed, (0, 4),
            with_prev, need_gram) for with_prev, need_gram in combos]
        errs["weighted_agg_indexed"].append(compare_weighted_agg_indexed(
            torch, f"weighted_agg_indexed {label}", N, K, d, idx, valid, seed))
    time_dfl_kernels(torch, 20, 8, 44426, seed=25)
    dfl_timed = time_dfl_kernels(torch, 64, 16, 1 << 20, seed=26)
    timed["wfagg_round_indexed"]["gram_variant"] = dfl_timed.pop("wfagg_round_indexed_gram")
    timed.update(dfl_timed)
    time_gram_epilogue(torch, 64, 32, 8192, seed=28)
    time_dfl_backends(torch, 64, 16, 1 << 20, seed=27)

    # ---- phase 3: the main paths --------------------------------------------
    print(f"[3] DFL main path: run_experiment, LeNet-5, paper topology, IPM-100, "
          f"{ROUNDS} rounds")
    data = SyntheticImages()
    cfg = DFLConfig(aggregator="wfagg", attack="ipm_100", model="lenet",
                    wfagg_backend="fused")
    zero_counts()
    out = run_experiment(cfg, topo, data, rounds=ROUNDS)
    dfl_counts = read_counts()
    base = run_experiment(DFLConfig(aggregator="mean", attack="ipm_100", model="lenet"),
                          topo, data, rounds=ROUNDS)
    for name, o in (("wfagg", out), ("mean", base)):
        s = o["series"]
        print(f"  {name:5s} benign acc per round "
              f"{[round(a, 4) for a in s['acc_benign_mean']]}, round ms "
              f"{[round(1e3 * t, 2) for t in s['round_seconds']]}")
    want = {name: ROUNDS if name == "wfagg_round_indexed" else 0 for name in KERNELS}
    if dfl_counts != want:
        raise AssertionError(f"DFL path launches {dfl_counts}, expected {want}")
    print(f"  launches on the DFL path: {dfl_counts} (one round kernel per round)")
    if not all(np.isfinite(e["acc_all"]).all() for e in out["trace"]):
        raise AssertionError("non-finite accuracy on the main path")
    check_against_reference(torch, cfg, topo, data, ROUNDS)

    print(f"[3] DFL Alt-WFAgg and the two-launch backend: run_experiment, LeNet-5, "
          f"paper topology, IPM-100, {ROUNDS} rounds")
    dfl_launches = dict(dfl_counts)
    times = {"wfagg on fused": out, "mean": base}
    for agg, backend in (("alt_wfagg", "fused"), ("alt_wfagg", "fused_two_launch"),
                         ("wfagg", "fused_two_launch")):
        cfg = DFLConfig(aggregator=agg, attack="ipm_100", model="lenet",
                        wfagg_backend=backend)
        zero_counts()
        o = run_experiment(cfg, topo, data, rounds=ROUNDS)
        counts = read_counts()
        want = dict.fromkeys(KERNELS, 0)
        if backend == "fused":
            want["wfagg_round_indexed"] = ROUNDS
        else:
            want["robust_stats_indexed"] = want["weighted_agg_indexed"] = ROUNDS
        if counts != want:
            raise AssertionError(f"DFL {agg} on {backend} launches {counts}, "
                                 f"expected {want}")
        print(f"  launches on the DFL {agg} {backend} path: {counts}")
        if not all(np.isfinite(e["acc_all"]).all() for e in o["trace"]):
            raise AssertionError(f"non-finite accuracy on the DFL {agg} {backend} path")
        for name in KERNELS:
            dfl_launches[name] += counts[name]
        times[f"{agg} on {backend}"] = o
        check_against_reference(torch, cfg, topo, data, ROUNDS)
        if agg == "alt_wfagg" and backend == "fused":
            # the Gram epilogue against the second route: kernels 2 and 3
            # and the host scoring stage
            check_against_reference(torch, cfg, topo, data, ROUNDS,
                                    against="fused_two_launch")
    for name, o in times.items():
        s = o["series"]
        print(f"  {name:27s} benign acc per round "
              f"{[round(a, 4) for a in s['acc_benign_mean']]}, round ms "
              f"{[round(1e3 * t, 2) for t in s['round_seconds']]}")

    accs = {}
    for agg in ("mean", "wfagg", "alt_wfagg", "multi_krum", "clustering"):
        o = run_experiment(DFLConfig(aggregator=agg, attack="ipm_100", model="mlp"),
                           paper_topology(), data, rounds=4, eval_every=4)
        accs[agg] = o["final"]["acc_benign_mean"]
    print("  DFL IPM-100 claim (MLP, 4 rounds): " + ", ".join(
        f"{agg} {a:.4f}" for agg, a in accs.items()))
    for agg in ("wfagg", "alt_wfagg"):
        if not (accs[agg] > 0.9 and accs[agg] > accs["mean"] + 0.2):
            raise AssertionError(f"DFL IPM-100 claim does not hold for {agg}: {accs}")

    print(f"[3] CFL main path: run_experiment(centralized=True), LeNet-5, the same "
          f"topology, IPM-100, {ROUNDS} rounds")
    cfl_launches = dict.fromkeys(KERNELS, 0)
    for agg in ("wfagg", "alt_wfagg"):
        cfg = DFLConfig(aggregator=agg, attack="ipm_100", model="lenet", centralized=True)
        zero_counts()
        o = run_experiment(cfg, topo, data, rounds=ROUNDS)
        counts = read_counts()
        want = dict(dict.fromkeys(KERNELS, 0), robust_stats=ROUNDS, weighted_agg=ROUNDS,
                    pairwise_gram=ROUNDS if agg == "alt_wfagg" else 0)
        s = o["series"]
        print(f"  {agg:9s} benign acc per round "
              f"{[round(a, 4) for a in s['acc_benign_mean']]}, round ms "
              f"{[round(1e3 * t, 2) for t in s['round_seconds']]}")
        if counts != want:
            raise AssertionError(f"CFL {agg} launches {counts}, expected {want}")
        print(f"  launches on the CFL {agg} path: {counts}")
        if not all(np.isfinite(e["acc_all"]).all() for e in o["trace"]):
            raise AssertionError(f"non-finite accuracy on the CFL {agg} path")
        for name in KERNELS:
            cfl_launches[name] += counts[name]
        check_cfl_against_reference(torch, cfg, topo, data, ROUNDS)

    accs = {}
    for agg in ("mean", "wfagg", "alt_wfagg"):
        o = run_experiment(DFLConfig(aggregator=agg, attack="ipm_100", model="mlp",
                                     centralized=True),
                           paper_topology(), data, rounds=4, eval_every=4)
        accs[agg] = o["final"]["acc_benign_mean"]
    print(f"  CFL IPM-100 claim (MLP, 4 rounds): wfagg {accs['wfagg']:.4f}, "
          f"alt_wfagg {accs['alt_wfagg']:.4f}, mean {accs['mean']:.4f}")
    if not (accs["wfagg"] > accs["mean"] + 0.2 and accs["alt_wfagg"] > accs["mean"] + 0.2):
        raise AssertionError(f"CFL IPM-100 claim does not hold: {accs}")

    # each kernel's launches on the main paths that run it: the round kernel
    # on the DFL WFAgg and Alt-WFAgg runs, kernels 2 and 3 on the two
    # two-launch runs, the CFL kernels on the two CFL runs
    launches = {name: dfl_launches[name] + cfl_launches[name] for name in KERNELS}
    print(json.dumps({"kernels": [dict(
        name=name, route="cuda", source=src, replaces=replaces,
        launches=launches[name], max_abs_err=max(errs[name]), **timed[name])
        for name, (_, _, src, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
