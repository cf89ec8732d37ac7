#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs on
an NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; exits non-zero (and
prints no result) without them or outside a checkout of the repository.
Phases, each of which fails the run:

  1. the card's name and power limit; build the seven kernel libraries of
     the port from the sources in the checkout, one ``nvcc`` each, all
     started together (timed; ptxas registers and spills printed per
     kernel and template, kernel 8's bf16 tensor-core kernel per head dim
     among them; kernel 5 is a node axis on kernel 4's source, the
     per-edge variants are kernels 1 and 2, kernel 8 is ``flash_attn.cu``)
     and the thread-block cluster size (CTAs per node) of kernels 1 and 2;
     and, for kernels 4 and 5 at their timed shapes, the stages of the
     ``cp.async`` ring, the tile width, the CTAs per SM and per node and
     the network's width;
  2. hold each kernel against its plain PyTorch version on the card (a
     mask of kernel 1 or 2 that differs from the plain version's must be a
     near-tie by phase 3's rule, ``NEAR_TIE``: within 1e-4, relative, of a
     WFAgg-T band edge or the distance filter's keep boundary, reported
     with its filter and margin; on its node the masks and weights are
     ``derive_trust_weights`` of the kernel's own statistics and ``out``
     their combine):
     - the gossip round (``wfagg_round.cu``) at the paper's round shape
       (N=20, K=8, d=44,426) and on irregular slates with a degree-0 row
       at K=16 and K=32 (masks bit-equal, ``out`` within 3e-5);
     - the single-matrix statistics (``robust_stats.cu``) at the CFL
       server's shape (K=20, d=44,426, two bit-identical rows) with and
       without ``prev`` and the centers, and at K=7 and K=32 (median
       bit-equal, trimmed mean within rtol 1e-5, statistics within rtol
       1e-4 / atol 1e-3, WFAgg-D/C masks bit-equal, identical rows with
       identical sums);
     - the Gram (``pairwise_gram.cu``) at K=20, d=44,426 (D % 4 = 2), at
       K=32, D=2^22 and at K=7 and K=32 with D=37, less than a tile (within
       rtol 1e-4, exactly symmetric, norm2 its diagonal, Multi-Krum and
       Clustering masks bit-equal; two bit-identical rows a, b with
       bit-identical Gram rows, G[a,a] == G[a,b] == G[b,b] and squared
       distance exactly 0);
     - the combine (``weighted_agg.cu``) within 3e-5, and exactly ``local``
       with all-zero weights;
     - the round kernel's Gram variant (Alt-WFAgg) on the paper's ring and
       on irregular slates with a degree-0 row at K=8/16/20/32 (K=20 at
       d=44,426, K=32 at d=20,011), each with two
       bit-identical rows (G[a,a] == G[a,b] == G[b,b]): masks and weights equal to
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
     d=2^20 (kernels 1 and 2 in every variant at both shapes, printed in
     one table beside their bounds, plain versions and their times before
     their redesign onto one phase-0 body); the Gram variant's cost by
     difference at N=64, K=32, d=8192;
     and the gossip aggregation on ``fused`` against ``fused_two_launch``
     at N=64, K=16, d=2^20;
     then the ``prev_idx`` variants of the round kernel (plain and Gram)
     and of the gather-free statistics (with and without the Gram) on
     stacked chaos matrices built by the port's own ``apply_transport``:
     the paper's shape under ``churn`` + ``chaos`` (a degree-0 row, a
     corrupt row, ``prev_idx`` != the table on most edges) and irregular
     slates at K=16 and K=32 (masks bit-equal, ``out`` within 3e-5,
     statistics within rtol 1e-4, the Gram within 1e-4 of its
     Cauchy-Schwarz scale; with ``prev_idx`` = the table, bit-identical
     to the launch without it), timed at N=64, K=16, d=2^20 and at the
     paper's shape (L=3, C=4); a candidate row whose squared norm
     overflows float32 (+-inf statistics exactly where the plain version
     has them, no NaN); kernels 1 and 2 bit for bit against
     ``ref.robust_stats_indexed_kernel_order`` (the emulation of their
     summation order that the CPU tests hold against the JAX package) on
     the Gram-round slates at K=8/16/20/32, and kernel 1's statistics
     bit-identical to kernel 2's;
     then kernel 5, the gathered statistics (``robust_stats.cu``'s node
     axis), at the paper's gathered round (N=20, K=8, d=44,426, per-edge
     prev) and at N=64, K=16, d=2^20 with per-edge prev and without prev
     with the centers, each with two bit-identical rows per node and a NaN
     row (median bit-equal with NaN in the same places, the NaN node's
     median all NaN, sums within rtol 1e-4, tied rows tied, WFAgg-D/C
     masks bit-equal), each timed; kernels 4 and 5 bit for bit against
     ``ref.robust_stats_kernel_order`` (the emulation of their order that
     the CPU tests hold against the JAX package; the number of values
     compared printed) at their timed shapes, at D % 4 = 2 (kernel 4 at
     K=20 d=44,426, kernel 5 unpadded at N=20 K=8 d=44,426) and with the
     centers, NaN in the same places; and the per-edge (N, K, d) ``prev``
     variants of kernels 1 and 2 on the same slates as the Gram round
     (with ``prev[idx]`` bit-identical to the matrix-prev launch; with a
     per-edge prev of their own, masks bit-equal to the plain versions),
     timed at N=64, K=16, d=2^20 and at the paper's shape;
     then kernel 8, flash attention (``flash_attn.cu``: bf16 on the tensor
     cores, f32 on the CUDA cores), each case twice: through the wrapper
     the prefill calls (``ops.flash_attention`` on (B, H, S, hd) views) and
     at kernel level on inputs padded to the reference's blocks: the six
     cases of ``tests/test_kernels.py:209-216``, a case with Sq > Sk (rows
     with no live key), hd 80 and 128 with ragged padding, the same
     branches in bf16 (hd 32 ragged, Sq > Sk, Sk not a multiple of 64, hd
     128 non-causal), and the prefill's attention at Qwen1.5-0.5B width
     (B=2, 16 heads of 64, S=8192) in bf16 and in f32 (o, m and l within
     2e-5 in f32; in bf16 o within one rounding of its plain version,
     rtol 2^-7 and atol 1e-5, and m and l, which are f32, within 2e-5;
     rows with no live key exactly o = 0, m = -1e30, l = 0; every bf16
     call on the tensor-core kernel; bf16 o a step off the plain version
     counted beside the same count for the plain version's emulation of
     the split of p); a misaligned bf16 pointer and an hd without a
     kernel raise without a launch; timed at the prefill's shape beside
     its bound (bf16 tensor-core rate in bf16, f32 CUDA-core rate in f32),
     the plain version and ``F.scaled_dot_product_attention``;
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
       Multi-Krum and Clustering printed beside them) on the MLP, read
       from Table I: all 12 aggregators in DFL and in CFL
       (``run_experiment``, MLP, 4 rounds; kernels launched only under
       WFAgg and Alt-WFAgg, exactly as counted; accuracies and round times
       printed);
     - CFL (``centralized=True``, the same topology and attack): WFAgg
       (one statistics and one combine launch per round, no Gram) and
       Alt-WFAgg (one of each of the three), each replayed round by round
       against the reference backend on the card, and the centralized
       IPM-100 claim (WFAgg and Alt-WFAgg each > mean + 0.2) on the MLP,
       from Table I;
     - dynamic topologies and chaos transport (``run_dynamic_experiment``,
       the same model, topology and attack, 6 rounds): WFAgg on ``fused``
       under ``churn`` (6 round-kernel launches, none of the ``prev_idx``
       variant); under ``churn`` + ``chaos`` at intensity 0.4 WFAgg and
       Alt-WFAgg on ``fused`` (6 round-kernel launches, all ``prev_idx``),
       WFAgg on ``fused_two_launch`` (6 + 6, the statistics all
       ``prev_idx``) and the mean (none); each WFAgg run replayed round by
       round against the reference backend; one round of each under
       ``torch.cuda.set_sync_debug_mode("error")`` (no host sync inside a
       round); kill-and-resume (stop after 3, checkpoint, resume:
       ``torch.equal`` final carry); the padded baselines (median and
       Multi-Krum under ``churn`` and under ``churn`` + ``chaos``, no
       kernel); every series finite under ``corrupt`` at 0.5 for WFAgg,
       the mean and the median (MLP); benign accuracy under chaos printed;
     - the gathered ``wfagg_batch`` (``neighbor_idx`` None) with per-edge
       WFAgg-T state over 6 rounds of the paper's DFL configuration
       (LeNet-5, IPM-100; each node's 8 received models gathered from the
       round's trained and attacked matrix, the output the next round's
       models), WFAgg and Alt-WFAgg on ``fused``: one kernel-5 launch per
       round; every round also on the gathered ``reference`` backend (no
       kernel) and on the indexed ``fused`` (one per-edge round-kernel
       launch) and ``fused_two_launch`` (one per-edge statistics and one
       combine launch) paths fed the same per-edge state, masks equal (or
       reported with filter and margin), outputs within 3e-5, nodes that
       received a non-finite row compared with ``equal_nan`` against the
       gathered reference and reported;
     - serving Qwen1.5-0.5B at full width and depth (24 layers, d_model
       1024, vocab 151,936; the port's own init, seed 0): ``build_prefill``
       on 2 prompts of 8192 tokens (warm once, then timed: ms, prompt
       tokens/s, peak memory; 24 kernel-8 launches a call, all on the bf16
       tensor-core kernel), the same
       prompts with ``flash=False`` (the chunked online softmax; the
       logits of each prompt's last 256 positions compared),
       ``build_decode_step`` at batch 4 against a cache of 32,768
       positions (a 64-token prompt, then 32 greedy tokens: ms a step, no
       kernel launch), and the 96 stepped logits against one prefill of
       the same tokens.  Both logit comparisons hold a relative rms within
       2e-2 and a largest difference within 0.125, and top-1 equal except
       at near-ties (top-2 margin below 0.25), which are reported.

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
BF16_TC_OPS_PER_S = 989e12       # H100 SXM bf16 on the tensor cores, dense
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
    # the prev_idx variants (chaos transport): the same sources and kernels,
    # counted apart as well
    "wfagg_round_indexed[prev_idx]": ("repro_torch.kernels.robust_stats.kernel",
                                      "prev_idx_launches",
                                      "src/repro_torch/kernels/robust_stats/csrc/"
                                      "wfagg_round.cu",
                                      "src/repro/kernels/robust_stats/kernel.py:511"),
    "robust_stats_indexed[prev_idx]": ("repro_torch.kernels.robust_stats.kernel",
                                       "indexed_prev_idx_launches",
                                       "src/repro_torch/kernels/robust_stats/csrc/"
                                       "robust_stats_indexed.cu",
                                       "src/repro/kernels/robust_stats/kernel.py:271"),
    # kernel 5: the gathered statistics, a node axis on kernel 4's source
    "robust_stats_batch": ("repro_torch.kernels.robust_stats.kernel", "batch_launches",
                           "src/repro_torch/kernels/robust_stats/csrc/robust_stats.cu",
                           "src/repro/kernels/robust_stats/kernel.py:652"),
    # the per-edge (N, K, D) prev variants: the prev_idx launches over the
    # per-edge tensor, counted apart
    "wfagg_round_indexed[per_edge_prev]": ("repro_torch.kernels.robust_stats.kernel",
                                           "per_edge_launches",
                                           "src/repro_torch/kernels/robust_stats/csrc/"
                                           "wfagg_round.cu",
                                           "src/repro/kernels/robust_stats/kernel.py:511"),
    "robust_stats_indexed[per_edge_prev]": ("repro_torch.kernels.robust_stats.kernel",
                                            "indexed_per_edge_launches",
                                            "src/repro_torch/kernels/robust_stats/csrc/"
                                            "robust_stats_indexed.cu",
                                            "src/repro/kernels/robust_stats/kernel.py:271"),
    # kernel 8: the LM's prefill attention
    "flash_attention": ("repro_torch.kernels.flash_attn.kernel", "launches",
                        "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu",
                        "src/repro/kernels/flash_attn/kernel.py:81"),
}


def _module(name):
    import importlib
    return importlib.import_module(KERNELS[name][0])


def zero_counts() -> None:
    for name, (_, attr, _, _) in KERNELS.items():
        setattr(_module(name), attr, 0)
    # kernel 8's bf16 tensor-core launches, also counted in its ``launches``
    _module("flash_attention").launches_tc = 0


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
    tbands = jittered_bands(torch, robust_stats_indexed_ref(models, idx_t, valid_t, prev),
                            g, cfg)
    return models, prev, idx_t, valid_t, tbands, cfg


def jittered_bands(torch, st, g, cfg):
    """WFAgg-T bands from a history of each edge's own temporal metrics in
    ``st``, each entry jittered by 5%: some edges pass, others fail."""
    from repro_torch.core import trust

    N, K = st.prev_dist2.shape
    jitter = lambda x: x[:, None, :] * (1 + 0.05 * torch.randn(  # noqa: E731
        (N, cfg.window, K), generator=g, device="cuda"))
    return trust.temporal_bands(
        jitter(st.prev_dist2), jitter(st.cosine_to_prev()),
        torch.full((N,), 3, device="cuda"), torch.full((N,), 5, device="cuda"), cfg)


def assert_stats_close(torch, got, want, fields) -> float:
    """Statistics ``fields`` of a kernel within rtol 1e-4 / atol 1e-3 of its
    plain version's (a NaN fails); returns the largest difference."""
    for name in fields:
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   rtol=STAT_RTOL, atol=STAT_ATOL)
    return max(float((getattr(got, n) - getattr(want, n)).abs().max()) for n in fields)


def hold_masks(torch, label, got, want, st, v, tb, cfg) -> "torch.Tensor":
    """A kernel's masks ``got`` (mask_d, mask_c[, mask_t]) against its plain
    version's ``want``: bit-equal, or each differing edge a near-tie by the
    rule of phase 3 (``near_ties_only``: within NEAR_TIE, relative, of a
    WFAgg-T band edge or of the distance filter's keep boundary, measured
    on the plain version's own statistics ``st``), reported with its
    filter and margin.  A similarity (Clustering, WFAgg-C) flip has no
    margin and fails.  Returns the (N,) nodes holding such an edge."""
    flips = [(n, k, bit) for bit, (g, w) in enumerate(zip(got, want))
             for n, k in (g != w).nonzero().tolist()]
    off = torch.zeros(got[0].shape[0], dtype=torch.bool, device=got[0].device)
    if not flips:
        return off
    report = flip_margins(torch, st, v, tb, cfg, flips)
    print(f"  {label}: masks differ from the plain version at (node, slot, filter, "
          f"margin) {report}")
    if not near_ties_only(report):
        raise AssertionError(f"{label}: masks differ from the plain version away from "
                             "any edge")
    off[[n for n, _, _ in flips]] = True
    return off


def hold_round(torch, label, got, want, v, tb, cfg, local, models, idx) -> tuple:
    """A round kernel's outputs (out, w, mask_d, mask_c, mask_t, stats)
    against its plain version's: masks as ``hold_masks``; weights within
    atol 1e-6 and ``out`` within 3e-5 of the plain version's; on a node
    with a near-tie, the masks and weights those of ``derive_trust_weights``
    of the kernel's own statistics and ``out`` within 3e-5 of the plain
    combine of its own weights.  Returns (largest ``out`` error, near-ties)."""
    from repro_torch.core import trust
    from repro_torch.kernels.weighted_agg.ops import weighted_agg_indexed_plain

    off = hold_masks(torch, label, got[2:5], want[2:5], want[5], v, tb, cfg)
    keep = ~off
    torch.testing.assert_close(got[1][keep], want[1][keep], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[0][keep], want[0][keep], rtol=OUT_TOL, atol=OUT_TOL)
    err = float((got[0][keep] - want[0][keep]).abs().max()) if keep.any() else 0.0
    if off.any():
        own = trust.derive_trust_weights(got[5], v, tb, cfg)
        for name, g, o in zip(("mask_d", "mask_c", "mask_t"), got[2:5], own):
            if not torch.equal(g[off], o[off]):
                raise AssertionError(f"{label}: {name} at a near-tie is not "
                                     "derive_trust_weights' of the kernel's own stats")
        torch.testing.assert_close(got[1][off], own[3][off], rtol=0, atol=1e-6)
        mine = weighted_agg_indexed_plain(*trust.combine_coefficients(got[1], cfg.alpha),
                                          local, models, idx)
        torch.testing.assert_close(got[0][off], mine[off], rtol=OUT_TOL, atol=OUT_TOL)
        err = max(err, float((got[0][off] - mine[off]).abs().max()))
    return err, int(off.sum())


def tie_note(n_ties: int) -> str:
    return f" but for the near-ties of {n_ties} nodes reported above" if n_ties else ""


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
    err, n_ties = hold_round(torch, label, got, want, v, tbands, cfg, models, models, idx_t)
    assert_stats_close(torch, got[5], want[5], STAT_FIELDS)
    if dup is not None:
        # bit-identical rows got bit-identical statistics
        a, b = (idx_t == dup[0]), (idx_t == dup[1])
        both = a.any(1) & b.any(1)
        da = torch.where(a, got[5].dist2, 0).sum(1)[both]
        db = torch.where(b, got[5].dist2, 0).sum(1)[both]
        if not torch.equal(da, db):
            raise AssertionError(f"{label}: identical rows got different dist2")
    mask_t_on = int(got[4].sum())
    print(f"  {label}: masks bit-equal{tie_note(n_ties)} (mask_t on "
          f"{mask_t_on} of {int(v.sum())} edges), out max|err| {err:.3g}")
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
    """Kernel (through its ``*_cuda`` wrapper, as every variant is timed) and
    plain times at one shape, with the kernel's bound."""
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats import ops

    idx = [[(n + o) % N for o in range(1, K + 1)] for n in range(N)]
    models, prev, idx_t, _, tbands, cfg = round_inputs(torch, N, K, d, idx, None, seed)
    local = models.clone()
    v = torch.ones((N, K), dtype=torch.bool, device="cuda")
    i32 = idx_t.to(torch.int32)
    ms = time_cuda(torch, lambda: rk.wfagg_round_indexed_cuda(
        local, models, i32, v, prev, tbands, cfg, cfg.alpha, False), 3, 25)
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
    if not torch.equal(norm2, torch.diagonal(gram)):
        raise AssertionError(f"{label}: norm2 is not the Gram's diagonal")
    # the tie invariant: the twins' Gram rows bit-identical, their own
    # block of four entries one value, their distance exactly 0
    others = [j for j in range(K) if j not in (0, dup)]
    if not torch.equal(gram[0, others], gram[dup, others]):
        raise AssertionError(f"{label}: identical rows got different Gram rows")
    tie = {float(gram[a, b]) for a in (0, dup) for b in (0, dup)}
    if len(tie) != 1:
        raise AssertionError(f"{label}: G[a,a], G[a,b], G[b,b] of twin rows differ: {tie}")
    d2 = trust.sq_dists_from_gram(gram)
    if float(d2[0, dup]) != 0.0 or float(d2[dup, 0]) != 0.0:
        raise AssertionError(f"{label}: twin rows at squared distance {float(d2[0, dup])}")
    stats = robust_stats_plain(u, need_center=False)
    cfg = alt_wfagg_config(multi_krum_m=max(1, int(0.25 * K)))
    for fn in (trust.fused_distance_mask, trust.fused_similarity_mask):
        if not torch.equal(fn(stats, gram, cfg), fn(stats, gp, cfg)):
            raise AssertionError(f"{label}: {fn.__name__} differs with the plain Gram")
    err = float((gram - gp).abs().max())
    print(f"  {label}: symmetric, Multi-Krum and Clustering masks bit-equal, "
          f"identical rows tied (G[a,a] == G[a,b] == G[b,b], distance 0), max|err| "
          f"{err:.3g}")
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


def tie_mask(torch, ties, N, K):
    """(N, K, K) bool: the slot pairs of ``tied_nodes``."""
    m = torch.zeros((N, K, K), dtype=torch.bool, device="cuda")
    for n, ka, kb in ties:
        m[n, ka, kb] = m[n, kb, ka] = True
    return m


def check_ties(torch, label, stats, ties, fields):
    """Identical rows got bit-identical statistics and Gram rows, and a
    squared distance of exactly 0 to each other."""
    from repro_torch.core import trust

    for n, ka, kb in ties:
        for name in fields:
            x = getattr(stats, name)
            if x is not None and not torch.equal(x[n, ka], x[n, kb]):
                raise AssertionError(f"{label}: identical rows got different {name}")
        if stats.gram is not None:
            g = stats.gram[n]
            others = [j for j in range(g.shape[0]) if j not in (ka, kb)]
            if not (torch.equal(g[ka, others], g[kb, others])
                    and torch.equal(g[ka, ka], g[kb, kb])
                    and torch.equal(g[ka, ka], g[ka, kb])):
                raise AssertionError(f"{label}: identical rows got different Gram rows "
                                     "(or G[a,a], G[a,b], G[b,b] not all equal)")
            if trust.sq_dists_from_gram(g)[ka, kb] != 0:
                raise AssertionError(f"{label}: identical rows at a squared distance "
                                     "other than 0")


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
    for name, g, o in zip(("mask_d", "mask_c", "mask_t"), got[2:5], own):
        if not torch.equal(g, o):
            raise AssertionError(f"{label}: the epilogue's {name} differs from "
                                 f"derive_trust_weights of its own stats at "
                                 f"{int((g != o).sum())} edges")
    if not torch.equal(got[1], own[3]):
        raise AssertionError(f"{label}: the epilogue's weights differ from "
                             "derive_trust_weights of its own stats")
    gram, gp = got[5].gram, want[5].gram
    if not torch.equal(gram, gram.transpose(1, 2)):
        raise AssertionError(f"{label}: Gram not exactly symmetric")
    torch.testing.assert_close(gram, gp, rtol=1e-4, atol=1e-6 * d)
    err, n_ties = hold_round(torch, label, got, want, v, tbands, cfg, models, models, idx_t)
    assert_stats_close(torch, got[5], want[5], STAT_FIELDS)
    ties = tied_nodes(torch, idx_t, valid_t, dup)
    check_ties(torch, label, got[5], ties, ("dist2", "dotmed", "norm2"))
    check_twins(torch, f"{label} (plain)", gp, tie_mask(torch, ties, N, K))
    print(f"  {label}: masks bit-equal to the plain version{tie_note(n_ties)} and to "
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
    errs = [assert_stats_close(torch, got, want, fields)]
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
    if need_gram:
        check_twins(torch, f"{label} (plain)", want.gram, tie_mask(torch, ties, N, K))
    cfgs = [WFAggConfig()] + ([alt_config(K)] if need_gram else [])
    for cfg in cfgs:
        mk = lambda st: trust.derive_trust_weights(st, v, None, cfg)[:2]  # noqa: E731
        hold_masks(torch, f"{label} masks from the statistics ({cfg.distance_filter})",
                   mk(got), mk(want), want, v, None, cfg)
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
    b = bound(4.0 * 2 * N * d, 16.0 * K * N * d)  # models and prev once
    out["robust_stats_indexed_no_gram"] = dict(
        ms=time_cuda(torch, lambda: rk.robust_stats_indexed_cuda(
            models, i32, v, prev, False), 3, 25),
        plain_ms=time_cuda(torch, lambda: robust_stats_indexed_ref(
            models, idx_t, v, prev), 1, 5),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    b = bound(4.0 * 2 * N * d, n_ops)             # models and prev once
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
        name = name.replace("_no_gram", " (prev, without the Gram)")
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


# kernels 1 and 2 before their redesign onto one phase-0 body, in ms by
# (entry, shape), as PERF.md section 6 records them; "big" is N=64, K=16,
# d=2^20, "paper" N=20, K=8, d=44,426
BEFORE_MS = {
    ("wfagg_round_indexed", "big"): 25.63,
    ("wfagg_round_indexed[prev_idx]", "big"): 31.32,
    ("wfagg_round_indexed[per_edge_prev]", "big"): 37.50,
    ("robust_stats_indexed", "big"): 14.04,
    ("robust_stats_indexed[prev_idx]", "big"): 6.03,
    ("robust_stats_indexed[per_edge_prev]", "big"): 7.18,
    ("wfagg_round_indexed", "paper"): 0.62,
    ("robust_stats_indexed", "paper"): 0.10,
}

# (label, entry of the timings at N=64 K=16 d=2^20, entry at the paper's shape)
ROUND_KERNEL_VARIANTS = (
    ("kernel 1, WFAgg, matrix prev", "wfagg_round_indexed", "wfagg_round_indexed"),
    ("kernel 1, Gram (Alt-WFAgg), matrix prev", "wfagg_round_indexed.gram_variant",
     "wfagg_round_indexed_gram"),
    ("kernel 1, prev_idx", "wfagg_round_indexed[prev_idx]",
     "wfagg_round_indexed[prev_idx]"),
    ("kernel 1, per-edge prev", "wfagg_round_indexed[per_edge_prev]",
     "wfagg_round_indexed[per_edge_prev]"),
    ("kernel 2, prev + Gram", "robust_stats_indexed", "robust_stats_indexed"),
    ("kernel 2, prev, no Gram", "robust_stats_indexed_no_gram",
     "robust_stats_indexed_no_gram"),
    ("kernel 2, prev_idx", "robust_stats_indexed[prev_idx]",
     "robust_stats_indexed[prev_idx]"),
    ("kernel 2, per-edge prev", "robust_stats_indexed[per_edge_prev]",
     "robust_stats_indexed[per_edge_prev]"),
)


def print_cluster_sizes() -> None:
    """The thread-block cluster size (CTAs per node) kernels 1 and 2 take at
    the timed shapes."""
    from repro_torch.kernels.robust_stats import kernel as rk

    print("    kernels 1 and 2, CTAs per node (cluster size): " + ", ".join(
        f"{rk.cluster_size(d)} at d={d}" for d in (44426, 1 << 20, 20011, 37)))


# kernels 4 and 5 at their timed shapes: (label, N, K, D, prev, centers);
# kernel 5's d is padded to a multiple of 32 (ops.robust_stats_batch)
STATS_SHAPES = (
    ("kernel 4, K=20 d=44426, prev", 1, CFL_K, CFL_D, True, False),
    ("kernel 4, K=32 D=2^22, prev", 1, BIG_K, BIG_D, True, False),
    ("kernel 5, N=20 K=8 d=44448, per-edge prev", 20, 8, 44448, True, False),
    ("kernel 5, N=64 K=16 d=2^20, per-edge prev", 64, 16, 1 << 20, True, False),
    ("kernel 5, N=64 K=16 d=2^20, centers", 64, 16, 1 << 20, False, True),
)


def print_stats_plans() -> None:
    """How ``robust_stats.cu`` (kernels 4 and 5) runs at the timed shapes:
    the stages of its ``cp.async`` ring, the tile width, the CTAs an SM
    holds (the instance's occupancy) and the CTAs per node."""
    from repro_torch.kernels.robust_stats import kernel as rk

    for label, N, K, D, with_prev, centers in STATS_SHAPES:
        p = rk.stats_plan(N, K, D, with_prev, centers, "cuda")
        net = f"network width {p['kp']}" + (", specialised on K" if p["specialised"]
                                           else ", +inf padding")
        print(f"    {label}: {p['stages']} stages of {p['tile']}-coordinate tiles, "
              f"{p['ctas_per_sm']} CTAs per SM, {p['blocks']} CTAs per node, {net}")


def print_round_kernel_times(big: dict, paper: dict) -> None:
    """Kernels 1 and 2 in every variant at both shapes: time, bound, plain
    version, and the time before the redesign where PERF.md recorded one."""
    def get(table, key):
        name, _, sub = key.partition(".")
        return table[name][sub] if sub else table[name]

    print("  kernels 1 and 2 (one phase-0 body, a cluster per node), kernel ms / bound "
          "ms / plain ms, and before that redesign:")
    for label, kb, kp in ROUND_KERNEL_VARIANTS:
        for shape, table, key in (("big", big, kb), ("paper", paper, kp)):
            t = get(table, key)
            before = BEFORE_MS.get((key, shape))
            was = f"{before} ms (PERF.md)" if before else "not recorded"
            where = "N=64 K=16 d=2^20" if shape == "big" else "N=20 K=8 d=44426"
            print(f"    {label:42s} {where:17s} {t['ms']:9.4f} / {t['bound_ms']:.5f} "
                  f"({t['bound_by']}) / {t['plain_ms']:9.4f}; before: {was}")


def network_compare_exchanges(K: int) -> int:
    """Compare-exchanges of robust_stats.cu's median network on K wires: the
    odd-even merge sort on 8, 16 or 32 wires less those that touch a wire
    past K (``ref.network_pairs``, counted here so that the timers also run
    on a tree without it)."""
    kp = 8 if K <= 8 else 16 if K <= 16 else 32
    lg = kp.bit_length() - 1
    return sum(lo >= k % p and (lo - k % p) % (2 * k) < k and lo + k < K
               and lo // (2 * p) == (lo + k) // (2 * p)
               for p, k in ((1 << a, 1 << b) for a in range(lg) for b in range(a + 1))
               for lo in range(kp))


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / ops_per_s * 1e3
    return max(byte_ms, op_ms), ("bytes" if byte_ms >= op_ms else "operations")


def time_robust_stats(torch, u, prev) -> dict:
    """Kernel 4's wrapper (``robust_stats_cuda``) as the CFL server calls
    it, with the temporal tail and no centers, beside its plain version and
    its bound: read u and prev once; 2 ops per compare-exchange, 8 flops
    per candidate coordinate for dist2 / dotmed / norm2 and 7 for the
    tail."""
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats import ops as rops

    K, D = u.shape
    b = bound(4.0 * 2 * K * D, D * (2.0 * network_compare_exchanges(K) + 15.0 * K))
    return dict(
        ms=time_cuda(torch, lambda: rk.robust_stats_cuda(u, prev, 0.1, False), 3, 25),
        plain_ms=time_cuda(torch, lambda: rops.robust_stats_plain(
            u, prev, need_center=False), 1, 5),
        bound_ms=b[0], bound_by=b[1], library_ms=None)


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
    out = {"robust_stats": time_robust_stats(torch, u, prev)}
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
# phase 2: the prev_idx variants of kernels 1 and 2 (chaos transport)
# ---------------------------------------------------------------------------

def chaos_stack(torch, N, K, d, idx, valid, seed, fault_round=None, rnd=3, dup=(0, 4)):
    """One round's stacked chaos matrix, built by the port's own
    ``apply_transport`` on the card: models with two bit-identical attacker
    rows, a ring of three earlier matrices, a random served-lag table and
    a fault round (``fault_round``: numpy (drop, lag, dup, corrupt, down);
    random by default, with no crashed node).  Returns ``(flat, tout)``."""
    import numpy as np

    from repro_torch.dfl import faults as flt

    fcfg = flt.FaultConfig()
    g = torch.Generator(device="cuda").manual_seed(seed)
    flat = torch.randn((N, d), generator=g, device="cuda") + 0.3
    flat[dup[1]] = flat[dup[0]] = -100.0 * flat.mean(0)
    ring = flat + 0.2 * torch.randn((fcfg.ring_depth, N, d), generator=g, device="cuda")
    rng = np.random.default_rng(seed)
    served = rng.integers(0, 3, (N, K)).astype(np.int32)
    if fault_round is None:
        fault_round = (rng.random((N, K)) < 0.2, rng.integers(0, 3, (N, K)).astype(np.int32),
                       rng.random((N, K)) < 0.1, rng.random((N, K)) < 0.3,
                       np.zeros(N, bool))
    up = lambda x: torch.as_tensor(np.asarray(x), device="cuda")  # noqa: E731
    tout = flt.apply_transport(flat, flt.TransportState(ring, up(served)), up(idx),
                               up(valid), flt.FaultRound(*map(up, fault_round)), fcfg, rnd)
    return flat, tout


def chaos_bands(torch, tout, seed):
    """WFAgg-T bands around the round's own temporal metrics (prev read
    through ``prev_idx``), so the band test both accepts and rejects; the
    additive term keeps a band of width > 0 where an edge was served last
    round's payload again (s_t = b_t = 0; ``zero_width_bands`` holds that
    case)."""
    from repro_torch.core import trust
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    N, K = tout.eff_idx.shape
    st = robust_stats_indexed_ref(tout.full, tout.eff_idx, tout.eff_valid, tout.full,
                                  prev_idx=tout.prev_idx)
    g = torch.Generator(device="cuda").manual_seed(seed)
    rnd = lambda: torch.randn((N, 3, K), generator=g, device="cuda")  # noqa: E731
    jitter = lambda x: x[:, None, :] * (1 + 0.05 * rnd()) + 1e-3 * rnd()  # noqa: E731
    return trust.temporal_bands(jitter(st.prev_dist2), jitter(st.cosine_to_prev()),
                                torch.full((N,), 3, device="cuda"),
                                torch.full((N,), 5, device="cuda"), WFAggConfig(transient=3))


def zero_width_bands(torch, N, K):
    """WFAgg-T bands from a metric history of zeros, what the no-delivery
    hygiene leaves on an edge re-served its last payload round after
    round: zero width, at 0, on every edge.  A re-served payload has
    s_t = b_t = 0 exactly, on both edges of the band; the reference
    accepts it (``lo <= x <= hi``)."""
    from repro_torch.core import trust
    from repro_torch.core.wfagg import WFAggConfig

    z = torch.zeros((N, 3, K), device="cuda")
    return trust.temporal_bands(z, z, torch.full((N,), 3, device="cuda"),
                                torch.full((N,), 5, device="cuda"),
                                WFAggConfig(transient=3))


def twin_slots(torch, models, idx, v):
    """(N, K, K) bool: pairs of distinct valid slots of a node that read
    bit-identical nonzero rows (one row read twice, or two equal rows)."""
    u = models[idx.long()]
    K = idx.shape[1]
    same = torch.stack([(x[:, None] == x[None]).all(-1) for x in u])
    ok = v & (u != 0).any(-1)
    eye = torch.eye(K, dtype=torch.bool, device=u.device)
    return same & ok[:, :, None] & ok[:, None, :] & ~eye


def check_twins(torch, label, gram, twins) -> None:
    """Two slots that read bit-identical rows are at squared distance
    exactly 0 in the distances Multi-Krum reads from ``gram``."""
    from repro_torch.core import trust

    d2 = trust.sq_dists_from_gram(gram)[twins]
    if (d2 != 0).any():
        raise AssertionError(f"{label}: {int((d2 != 0).sum())} pairs of bit-identical "
                             f"candidates at a squared distance other than 0 "
                             f"(max {float(d2.max()):.3g})")


STAT_FIELDS = ("dist2", "dotmed", "norm2", "mednorm2", "prev_dist2", "prev_dot",
               "prev_norm2")


def same_outputs(torch, a, b) -> bool:
    """Bit-identical round or statistics outputs (tensors, RobustStats)."""
    if isinstance(a, tuple):
        return all(same_outputs(torch, x, y) for x, y in zip(a, b))
    if a is None or b is None:
        return a is b
    return torch.equal(a, b)


def check_gram(torch, label, gram, want, d) -> None:
    """A Gram of the stacked chaos matrix against the plain one: exactly
    symmetric, and each entry within 1e-4 of its Cauchy-Schwarz scale
    sqrt(G_ii G_jj) (+ 1e-6 d).  On the diagonal that is rtol 1e-4, as for
    the clean slates; off it, a finite corrupt row (norm ~1e3 sqrt(d)) and
    a plain one (~sqrt(d)) are nearly orthogonal, so their entry is a sum
    that cancels, and float32 sums in another order differ by a small
    fraction of the scale but more than 1e-4 of the entry."""
    if not torch.equal(gram, gram.transpose(1, 2)):
        raise AssertionError(f"{label}: Gram not exactly symmetric")
    diag = torch.diagonal(want, dim1=1, dim2=2).clamp(min=0)
    scale = torch.sqrt(diag[:, :, None] * diag[:, None, :])
    excess = (gram - want).abs() - (1e-4 * scale + 1e-6 * d)
    if (excess > 0).any():
        raise AssertionError(f"{label}: Gram off the plain one by more than 1e-4 of "
                             f"its scale at {int((excess > 0).sum())} entries")


def compare_prev_idx(torch, label, flat, tout, seed) -> dict:
    """Kernels 1 and 2 with ``prev_idx`` against their plain versions on one
    stacked chaos matrix (masks bit-equal, ``out`` within 3e-5, statistics
    within rtol 1e-4), for WFAgg and Alt-WFAgg (the Gram variant) and with
    and without the Gram; bit-identical candidates at squared distance
    exactly 0 in every Gram; under zero-width bands at 0, WFAgg-T accepting
    exactly the valid edges re-served their last payload, as the plain
    version does; and, with ``prev_idx = neighbor_idx``, every output
    bit-identical to the launch without ``prev_idx``.  Returns the max
    errors by kernel variant."""
    from repro_torch.core import trust
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats import ops
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    full, idx, v, pidx = tout.full, tout.eff_idx, tout.eff_valid, tout.prev_idx
    N, K = idx.shape
    d = full.shape[1]
    tb = chaos_bands(torch, tout, seed)
    zb = zero_width_bands(torch, N, K)
    # s_t = 0 exactly: the edge reads last round's payload again
    reserved = v & (full[idx] == full[pidx]).all(-1)
    if not reserved.any():
        raise AssertionError(f"{label}: no valid edge was re-served its last payload")
    twins = twin_slots(torch, full, idx, v)
    errs = {"wfagg_round_indexed[prev_idx]": [], "robust_stats_indexed[prev_idx]": []}
    fired = []
    for cfg in (WFAggConfig(transient=3), alt_config(K)):
        name = f"{label} {cfg.distance_filter}"
        zk = ops.wfagg_round_indexed(flat, full, idx, v, cfg, prev=full, tbands=zb,
                                     prev_idx=pidx)[4]
        zp = ops.wfagg_round_indexed_plain(flat, full, idx, v, cfg, full, zb,
                                           prev_idx=pidx)[4]
        if not (torch.equal(zk, zp) and torch.equal(zp, reserved)):
            raise AssertionError(f"{name}: under zero-width bands mask_t is not the set "
                                 "of re-served edges in kernel and plain version")
        got = ops.wfagg_round_indexed(flat, full, idx, v, cfg, prev=full, tbands=tb,
                                      prev_idx=pidx)
        want = ops.wfagg_round_indexed_plain(flat, full, idx, v, cfg, full, tb,
                                             prev_idx=pidx)
        same = ops.wfagg_round_indexed(flat, full, idx, v, cfg, prev=full, tbands=tb,
                                       prev_idx=idx)
        old = ops.wfagg_round_indexed(flat, full, idx, v, cfg, prev=full, tbands=tb)
        torch.cuda.synchronize()
        err, _ = hold_round(torch, name, got, want, v, tb, cfg, flat, full, idx)
        assert_stats_close(torch, got[5], want[5], STAT_FIELDS)
        if got[5].gram is not None:
            check_gram(torch, name, got[5].gram, want[5].gram, d)
            check_twins(torch, name, got[5].gram, twins)
            check_twins(torch, f"{name} (plain)", want[5].gram, twins)
        if not same_outputs(torch, same, old):
            raise AssertionError(f"{name}: prev_idx = neighbor_idx is not bit-identical "
                                 "to the launch without prev_idx")
        errs["wfagg_round_indexed[prev_idx]"].append(err)
        fired.append(int(got[4].sum()))
    for need_gram in (False, True):
        got = ops.robust_stats_indexed(full, idx, v, full, need_gram=need_gram,
                                       prev_idx=pidx)
        want = robust_stats_indexed_ref(full, idx, v, full, need_gram=need_gram,
                                        prev_idx=pidx)
        same = ops.robust_stats_indexed(full, idx, v, full, need_gram=need_gram,
                                        prev_idx=idx)
        old = ops.robust_stats_indexed(full, idx, v, full, need_gram=need_gram)
        torch.cuda.synchronize()
        e = [assert_stats_close(torch, got, want, STAT_FIELDS)]
        if need_gram:
            check_gram(torch, f"{label} robust_stats_indexed", got.gram, want.gram, d)
            check_twins(torch, f"{label} robust_stats_indexed", got.gram, twins)
            check_twins(torch, f"{label} robust_stats_indexed (plain)", want.gram, twins)
        for cfg in (WFAggConfig(transient=3),) + ((alt_config(K),) if need_gram else ()):
            mk = lambda st: trust.derive_trust_weights(st, v, tb, cfg)[:3]  # noqa: E731
            hold_masks(torch, f"{label} robust_stats_indexed ({cfg.distance_filter})",
                       mk(got), mk(want), want, v, tb, cfg)
            if not torch.equal(trust.derive_trust_weights(got, v, zb, cfg)[2], reserved):
                raise AssertionError(f"{label} robust_stats_indexed: under zero-width "
                                     "bands mask_t is not the set of re-served edges")
        if not same_outputs(torch, tuple(same), tuple(old)):
            raise AssertionError(f"{label} robust_stats_indexed gram={need_gram}: prev_idx "
                                 "= neighbor_idx is not bit-identical to the launch "
                                 "without prev_idx")
        errs["robust_stats_indexed[prev_idx]"].append(max(e))
    print(f"  {label}: masks bit-equal for WFAgg and Alt-WFAgg (mask_t on {fired} of "
          f"{int(v.sum())} valid edges; under zero-width bands at 0 on the "
          f"{int(reserved.sum())} re-served edges exactly), {int(twins.sum()) // 2} pairs "
          f"of bit-identical candidates at squared distance 0 in every Gram, "
          f"{int((~v.any(1)).sum())} degree-0 rows, "
          f"prev_idx != neighbor_idx on {float((pidx != idx).float().mean()):.2f} of "
          f"the edges; with prev_idx = neighbor_idx both kernels bit-identical to the "
          f"launch without it; out max|err| "
          f"{max(errs['wfagg_round_indexed[prev_idx]']):.3g}, statistics max|err| "
          f"{max(errs['robust_stats_indexed[prev_idx]']):.3g}")
    return errs


def check_overflow_row(torch) -> None:
    """Kernels 1 and 2 on the paper's ring with one candidate row whose
    squared norm overflows float32 (a corrupt payload): +-inf statistics
    exactly where the plain version has them (their float32 terms overflow
    as the plain version's do, so none turns NaN), the rest
    within rtol 1e-4 / atol 1e-3 of it; the round's masks as
    ``hold_masks``."""
    from repro_torch.core.topology import make_topology
    from repro_torch.kernels.robust_stats import ops
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    topo = make_topology(20, 8, 2, "ring", placement="close")
    models, prev, idx_t, _, tb, _ = round_inputs(torch, 20, 8, 44426,
                                                 topo.neighbor_indices, None, seed=61)
    models[3] = 3e19
    v = torch.ones((20, 8), dtype=torch.bool, device="cuda")
    got = ops.robust_stats_indexed(models, idx_t, v, prev, need_gram=True)
    want = robust_stats_indexed_ref(models, idx_t, v, prev, need_gram=True)
    rnd = ops.wfagg_round_indexed(models, models, idx_t, v, alt_config(8), prev=prev,
                                  tbands=tb)
    rwant = ops.wfagg_round_indexed_plain(models, models, idx_t, v, alt_config(8), prev, tb)
    torch.cuda.synchronize()
    for label, st in (("robust_stats_indexed", got), ("wfagg_round_indexed", rnd[5])):
        for name in STAT_FIELDS:
            g, w = getattr(st, name), getattr(want, name)
            big = ~torch.isfinite(w)
            if not (torch.equal(g[big], w[big]) and torch.isfinite(g[~big]).all()):
                raise AssertionError(f"overflow row, {label}: {name} is not +-inf exactly "
                                     "where the plain version's is")
            torch.testing.assert_close(g[~big], w[~big], rtol=STAT_RTOL, atol=STAT_ATOL)
    hold_masks(torch, "overflow row, wfagg_round_indexed", rnd[2:5], rwant[2:5], rwant[5],
               v, tb, alt_config(8))
    n_inf = int((~torch.isfinite(want.norm2)).sum())
    print(f"  overflow row (|x| = 3e19, d=44426) on the paper ring: +-inf statistics at "
          f"the same {n_inf} slots' norm2 as the plain version in both kernels, no NaN; "
          "the rest within tolerance, round masks as the plain version's")


def check_kernel_order(torch, slates) -> None:
    """Kernels 1 and 2 against ``ref.robust_stats_indexed_kernel_order``, the
    plain emulation of their summation order that the CPU tests hold
    against the JAX package: every statistic and Gram entry bit-equal (the
    emulation's float64 ``fma`` could round twice and show a 1-ulp
    difference; these seeded inputs have none), at the cluster size the
    kernels take; and kernel 1's statistics bit-identical to kernel 2's
    (one phase-0 body).  Matrix prev, and a per-edge prev at K=20."""
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats import ops
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_kernel_order

    n_vals = 0
    for label, N, K, d, idx, valid, seed in slates:
        models, prev, idx_t, valid_t, _, _ = round_inputs(torch, N, K, d, idx, valid, seed,
                                                          (0, 4))
        v = (torch.ones((N, K), dtype=torch.bool, device="cuda") if valid_t is None
             else valid_t)
        p = prev[idx_t.long()] if K == 20 else prev
        got = ops.robust_stats_indexed(models, idx_t, v, p, need_gram=True)
        rnd = ops.wfagg_round_indexed(models, models, idx_t, valid_t, alt_config(K), prev=p)
        emu = robust_stats_indexed_kernel_order(models, idx_t, v, p, True,
                                                cluster=rk.cluster_size(d))
        torch.cuda.synchronize()
        for name in STAT_FIELDS + ("gram",):
            g, e, r = getattr(got, name), getattr(emu, name), getattr(rnd[5], name)
            if not torch.equal(g, e):
                raise AssertionError(f"kernel order {label}: {name} differs from the "
                                     f"emulation at {int((g != e).sum())} of {g.numel()}")
            if not torch.equal(r, g):
                raise AssertionError(f"kernel order {label}: the round kernel's {name} "
                                     "differs from the statistics kernel's")
            n_vals += g.numel()
    print(f"  kernels 1 and 2 == ref.robust_stats_indexed_kernel_order bit for bit "
          f"({n_vals} statistics and Gram entries on {len(slates)} slates), and "
          "kernel 1's statistics == kernel 2's")


def paper_chaos_stack(torch, d):
    """The paper's round shape (N=20, K=8) under ``churn`` + ``chaos``: the
    first round of the schedule that has a degree-0 row and a finite
    corrupt (bank) row among the valid edges."""
    from repro_torch.core.topology import make_topology
    from repro_torch.dfl.dynamics import make_faulty_schedule

    topo = make_topology(20, 8, 2, "ring", placement="close")
    sched, fs = make_faulty_schedule("churn", topo, 8, fault="chaos", intensity=0.4,
                                     seed=3, fault_seed=3)
    M = topo.n_nodes
    for r in range(sched.rounds):
        fr = [x[r] for x in (fs.drop, fs.lag, fs.dup, fs.corrupt, fs.down)]
        flat, tout = chaos_stack(torch, M, sched.width, d, sched.neighbor_idx[r],
                                 sched.valid[r], seed=31, fault_round=fr)
        bank_rows = tout.eff_idx >= tout.full.shape[0] - fs.config.bank_size
        if (~tout.eff_valid.any(1)).any() and (bank_rows & tout.eff_valid).any():
            return r, flat, tout
    raise AssertionError("no round of the schedule has a degree-0 row and a corrupt row")


def time_prev_idx_kernels(torch, N, K, d, seed) -> dict:
    """Kernels 1 and 2 with ``prev_idx`` through their ``*_cuda`` wrappers on a
    stacked chaos matrix (L=3, C=4: (L+1)·N + C rows) read through a ring
    slate, beside the same launch without ``prev_idx``, their plain
    versions and bounds.  The bound reads the distinct rows that the two
    tables reach once (and, for the round, ``local`` once and ``out``)."""
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats import ops as rops
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    idx = [[(n + o) % N for o in range(1, K + 1)] for n in range(N)]
    flat, tout = chaos_stack(torch, N, K, d, idx, [[True] * K] * N, seed)
    full, v = tout.full, tout.eff_valid
    i32, p32 = tout.eff_idx.to(torch.int32), tout.prev_idx.to(torch.int32)
    tb = chaos_bands(torch, tout, seed)
    cfg = WFAggConfig(transient=3)
    rows = int(torch.unique(torch.cat([tout.eff_idx.flatten(),
                                       tout.prev_idx.flatten()])).numel())
    out = {}
    base = time_cuda(torch, lambda: rk.wfagg_round_indexed_cuda(
        flat, full, i32, v, full, tb, cfg, cfg.alpha, False), 3, 25)
    b = bound(4.0 * d * (rows + 2 * N), 16.0 * N * K * d)
    out["wfagg_round_indexed[prev_idx]"] = dict(
        ms=time_cuda(torch, lambda: rk.wfagg_round_indexed_cuda(
            flat, full, i32, v, full, tb, cfg, cfg.alpha, False, prev_idx=p32), 3, 25),
        plain_ms=time_cuda(torch, lambda: rops.wfagg_round_indexed_plain(
            flat, full, tout.eff_idx, v, cfg, full, tb, prev_idx=tout.prev_idx), 1, 5),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    base2 = time_cuda(torch, lambda: rk.robust_stats_indexed_cuda(
        full, i32, v, full, False), 3, 25)
    b = bound(4.0 * d * rows, 16.0 * N * K * d)
    out["robust_stats_indexed[prev_idx]"] = dict(
        ms=time_cuda(torch, lambda: rk.robust_stats_indexed_cuda(
            full, i32, v, full, False, prev_idx=p32), 3, 25),
        plain_ms=time_cuda(torch, lambda: robust_stats_indexed_ref(
            full, tout.eff_idx, v, full, prev_idx=tout.prev_idx), 1, 5),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    print(f"  stacked chaos matrix N={N} K={K} d={d}: {full.shape[0]} rows, the two "
          f"tables reach {rows} distinct rows; without prev_idx (prev through the "
          f"neighbour table) the round kernel takes {base:.4f} ms and the statistics "
          f"kernel {base2:.4f} ms")
    for name, t in out.items():
        print(f"  {name} N={N} K={K} d={d}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}); "
              "no single PyTorch call computes this function")
    return out


# ---------------------------------------------------------------------------
# phase 2: kernel 5 (the gathered statistics) and the per-edge variants of
# kernels 1 and 2
# ---------------------------------------------------------------------------

def gathered_candidates(torch, N, K, d, seed, nan_node=None):
    """A gathered (N, K, d) tensor on the card and its per-edge ``prev``:
    every node's rows near a model of its own, row k at a noise scale of
    0.05 (k + 1) (so the filters' scores are apart by more than float32
    sums in another order can move them), rows 0 and ``K // 2`` one
    bit-identical attacker model (their prev rows identical too), and with
    ``nan_node`` a NaN row in that node's slot 1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = torch.randn((N, 1, d), generator=g, device="cuda")
    scale = 0.05 * torch.arange(1, K + 1, device="cuda", dtype=torch.float32)
    u = torch.randn((N, K, d), generator=g, device="cuda").mul_(scale[:, None]).add_(base)
    prev = torch.randn((N, K, d), generator=g, device="cuda").mul_(0.05).add_(u)
    tie = K // 2
    u[:, 0] = -3.0 * base[:, 0]
    u[:, tie] = u[:, 0]
    prev[:, tie] = prev[:, 0]
    if nan_node is not None:
        u[nan_node, 1] = float("nan")
    return u, prev, tie


def same_bits(torch, a, b) -> bool:
    """Equal values, NaN in the same places."""
    return torch.equal(torch.isnan(a), torch.isnan(b)) and \
        torch.equal(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


def compare_robust_stats_batch(torch, label, u, prev, tie, nan_node, need_center) -> float:
    """Kernel 5 against its plain version (``ref.robust_stats_batch_ref``):
    the median bit-equal with its NaN in the same places (the NaN node's
    median all NaN), the trimmed mean within rtol 1e-5, the statistics
    within rtol 1e-4 / atol 1e-3 with NaN in the same places, the tied rows
    bit-equal sums, and the WFAgg-D/C masks of every finite node bit-equal."""
    from repro_torch.core import trust
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats import ops
    from repro_torch.kernels.robust_stats.ref import robust_stats_batch_ref

    N = u.shape[0]
    got = ops.robust_stats_batch(u, prev, need_center=need_center)
    want = robust_stats_batch_ref(u, prev, need_center=need_center)
    torch.cuda.synchronize()
    errs = []
    if need_center:
        if not same_bits(torch, got.med, want.med):
            raise AssertionError(f"{label}: median differs from the plain version")
        torch.testing.assert_close(got.trim, want.trim, rtol=1e-5, atol=1e-6,
                                   equal_nan=True)
        fin = torch.isfinite(want.trim)
        errs.append(float((got.trim - want.trim)[fin].abs().max()))
        if nan_node is not None and not torch.isnan(got.med[nan_node]).all():
            raise AssertionError(f"{label}: the NaN row left a finite median")
    elif got.med is not None or got.trim is not None:
        raise AssertionError(f"{label}: centers returned without need_center")
    fields = STAT_FIELDS if prev is not None else STAT_FIELDS[:4]
    keep = torch.arange(N, device="cuda") != (-1 if nan_node is None else nan_node)
    for name in fields:
        g, w = getattr(got, name), getattr(want, name)
        torch.testing.assert_close(g, w, rtol=STAT_RTOL, atol=STAT_ATOL, equal_nan=True)
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            raise AssertionError(f"{label}: {name} NaN in other places than the plain")
        fin = torch.isfinite(w)
        errs.append(float((g - w)[fin].abs().max()))
        if g.ndim == 2 and not torch.equal(g[keep, 0], g[keep, tie]):
            raise AssertionError(f"{label}: identical rows got different {name}")
    if nan_node is not None and not torch.isnan(got.dist2[nan_node]).all():
        raise AssertionError(f"{label}: the NaN row left finite distances")
    cfg = WFAggConfig()
    for fn in (trust.fused_distance_mask, trust.fused_similarity_mask):
        if not torch.equal(fn(got, None, cfg)[keep], fn(want, None, cfg)[keep]):
            raise AssertionError(f"{label}: {fn.__name__} differs from the plain version")
    print(f"  {label}: median bit-equal, NaN in the same places"
          f"{'' if nan_node is None else f' (node {nan_node} all NaN)'}, masks "
          f"bit-equal, tied rows tied, max|err| {max(errs):.3g}")
    return max(errs)


def time_robust_stats_batch(torch, u, prev, need_center) -> dict:
    """Kernel 5's wrapper (``robust_stats_batch_cuda``) on the padded tensor
    the main path hands it, its plain version and its bound: read the
    candidates (and prev) once, write the centers; 2 ops per
    compare-exchange, 8 flops per candidate coordinate for dist2 / dotmed /
    norm2 and 7 for the temporal tail."""
    from repro_torch.kernels.common import pad_d
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats.ref import robust_stats_batch_ref

    N, K, d = u.shape
    up = pad_d(u, 32).contiguous()
    pp = None if prev is None else pad_d(prev, 32).contiguous()
    nbytes = 4.0 * N * K * d * (2 if prev is not None else 1) + (
        8.0 * N * d if need_center else 0.0)
    ops = N * d * (2.0 * network_compare_exchanges(K) + (15.0 if prev is not None
                                                         else 8.0) * K)
    b = bound(nbytes, ops)
    t = dict(ms=time_cuda(torch, lambda: rk.robust_stats_batch_cuda(up, pp, 0.1,
                                                                    need_center), 3, 25),
             plain_ms=time_cuda(torch, lambda: robust_stats_batch_ref(
                 u, prev, need_center=need_center), 1, 5),
             bound_ms=b[0], bound_by=b[1], library_ms=None)
    print(f"  robust_stats_batch N={N} K={K} d={d} prev={prev is not None} "
          f"centers={need_center}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
          f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}); no single PyTorch call "
          "computes these statistics")
    return t


def check_kernel5(torch) -> tuple:
    """Kernel 5 at the three shapes of PERF.md: the paper's gathered DFL
    round (N=20, K=8, d=44,426, per-edge prev, no centers) and N=64, K=16,
    d=2^20 with per-edge prev and no centers, and without prev with the
    centers; each with tied rows and a NaN row, then timed.  Returns the
    max errors and the times by shape."""
    errs, times = [], {}
    for N, K, d, with_prev, centers, seed in ((20, 8, 44426, True, False, 51),
                                              (64, 16, 1 << 20, True, False, 52),
                                              (64, 16, 1 << 20, False, True, 53)):
        u, prev, tie = gathered_candidates(torch, N, K, d, seed, nan_node=3)
        p = prev if with_prev else None
        label = f"robust_stats_batch N={N} K={K} d={d} prev={with_prev} centers={centers}"
        errs.append(compare_robust_stats_batch(torch, label, u, p, tie, 3, centers))
        u[3, 1] = u[3, 2]     # time finite inputs
        times[(N, K, d, with_prev, centers)] = time_robust_stats_batch(torch, u, p, centers)
        del u, prev, p
        torch.cuda.empty_cache()
    return errs, times


def check_stats_kernel_order(torch) -> None:
    """Kernels 4 and 5 (``robust_stats.cu``) bit for bit against
    ``ref.robust_stats_kernel_order``, the plain emulation of their order
    that the CPU tests hold against the JAX package, at the CTAs per node
    the wrappers take: every center and statistic equal, NaN in the same
    places.  Kernel 4 at its timed shapes (K=20 d=44,426, where D % 4 = 2
    and the copies are 8 bytes; K=32 D=2^22) with prev, and with the
    centers at K=20 and K=7; kernel 5 at its timed shapes (N=20 K=8 d
    padded to 44,448; N=64 K=16 d=2^20 with per-edge prev, and without
    prev with the centers) and unpadded at d=44,426, each with a NaN row
    (node 3) and tied rows."""
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats.ref import robust_stats_kernel_order

    def hold(label, got, emu, blocks) -> int:
        n = 0
        for name in ("med", "trim") + STAT_FIELDS:
            g, e = getattr(got, name), getattr(emu, name)
            if (g is None) != (e is None):
                raise AssertionError(f"kernel order {label}: {name} present in only one")
            if g is None:
                continue
            if not same_bits(torch, g, e):
                raise AssertionError(
                    f"kernel order {label} ({blocks} CTAs per node): {name} differs from "
                    f"the emulation at {int((g != e).sum())} of {g.numel()}")
            n += g.numel()
        return n

    n_vals, n_cases = 0, 0
    for K, D, with_prev, centers, seed in ((CFL_K, CFL_D, True, False, 71),
                                           (CFL_K, CFL_D, True, True, 72),
                                           (BIG_K, BIG_D, True, False, 73),
                                           (7, 20011, False, True, 74)):
        u, prev, _ = cfl_candidates(torch, K, D, seed)
        p = prev if with_prev else None
        blocks = rk.stats_plan(1, K, D, with_prev, centers, "cuda")["blocks"]
        got = rk.robust_stats_cuda(u, p, 0.1, centers)
        emu = robust_stats_kernel_order(u, p, 0.1, centers, blocks=blocks)
        torch.cuda.synchronize()
        n_vals += hold(f"kernel 4 K={K} D={D} prev={with_prev} centers={centers}", got,
                       emu, blocks)
        n_cases += 1
        del u, prev, p, got, emu
    for N, K, d, with_prev, centers, seed in ((20, 8, 44448, True, False, 75),
                                              (20, 8, 44426, True, True, 76),
                                              (64, 16, 1 << 20, True, False, 77),
                                              (64, 16, 1 << 20, False, True, 78)):
        u, prev, _ = gathered_candidates(torch, N, K, d, seed, nan_node=3)
        p = prev if with_prev else None
        blocks = rk.stats_plan(N, K, d, with_prev, centers, "cuda")["blocks"]
        got = rk.robust_stats_batch_cuda(u, p, 0.1, centers)
        emu = robust_stats_kernel_order(u, p, 0.1, centers, blocks=blocks)
        torch.cuda.synchronize()
        n_vals += hold(f"kernel 5 N={N} K={K} d={d} prev={with_prev} centers={centers}",
                       got, emu, blocks)
        n_cases += 1
        del u, prev, p, got, emu
        torch.cuda.empty_cache()
    print(f"  kernels 4 and 5 == ref.robust_stats_kernel_order bit for bit ({n_vals} "
          f"centers and statistics in {n_cases} launches, NaN in the same places)")


def compare_per_edge(torch, label, N, K, d, idx, valid, seed, dup) -> dict:
    """Kernels 1 and 2 with a per-edge (N, K, d) ``prev``: with ``prev[idx]``
    of a matrix, bit-identical to the launch that reads that matrix through
    the neighbour table; with a per-edge prev no matrix gives, against
    their plain versions (masks bit-equal, ``out`` within 3e-5, statistics
    within rtol 1e-4, the Gram within 1e-4 of its scale), for WFAgg and
    Alt-WFAgg and with and without the Gram.  Returns the max errors."""
    from repro_torch.core import trust
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats import ops
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    models, prev, idx_t, valid_t, tb, _ = round_inputs(torch, N, K, d, idx, valid,
                                                       seed, dup)
    v = (torch.ones((N, K), dtype=torch.bool, device="cuda") if valid_t is None
         else valid_t)
    edge = prev[idx_t.long()]
    g = torch.Generator(device="cuda").manual_seed(seed + 1000)
    own = edge + 0.01 * torch.randn(edge.shape, generator=g, device="cuda")
    # bands around the own prev's metrics (the matrix-prev pair reads ``tb``)
    otb = jittered_bands(torch, robust_stats_indexed_ref(models, idx_t, valid_t, own), g,
                         WFAggConfig(transient=3))
    errs = {"wfagg_round_indexed[per_edge_prev]": [],
            "robust_stats_indexed[per_edge_prev]": []}
    for cfg in (WFAggConfig(transient=3), alt_config(K)):
        name = f"{label} {cfg.distance_filter}"
        same = ops.wfagg_round_indexed(models, models, idx_t, valid_t, cfg, prev=edge,
                                       tbands=tb)
        old = ops.wfagg_round_indexed(models, models, idx_t, valid_t, cfg, prev=prev,
                                      tbands=tb)
        got = ops.wfagg_round_indexed(models, models, idx_t, valid_t, cfg, prev=own,
                                      tbands=otb)
        want = ops.wfagg_round_indexed_plain(models, models, idx_t, v, cfg, own, otb)
        torch.cuda.synchronize()
        if not same_outputs(torch, same, old):
            raise AssertionError(f"{name}: per-edge prev = prev[idx] is not bit-identical "
                                 "to the matrix-prev launch")
        err, _ = hold_round(torch, name, got, want, v, otb, cfg, models, models, idx_t)
        assert_stats_close(torch, got[5], want[5], STAT_FIELDS)
        if got[5].gram is not None:
            check_gram(torch, name, got[5].gram, want[5].gram, d)
        errs["wfagg_round_indexed[per_edge_prev]"].append(err)
    for need_gram in (False, True):
        same = ops.robust_stats_indexed(models, idx_t, valid_t, edge, need_gram=need_gram)
        old = ops.robust_stats_indexed(models, idx_t, valid_t, prev, need_gram=need_gram)
        got = ops.robust_stats_indexed(models, idx_t, valid_t, own, need_gram=need_gram)
        want = robust_stats_indexed_ref(models, idx_t, v, own, need_gram=need_gram)
        torch.cuda.synchronize()
        if not same_outputs(torch, tuple(same), tuple(old)):
            raise AssertionError(f"{label} robust_stats_indexed gram={need_gram}: "
                                 "per-edge prev = prev[idx] is not bit-identical to the "
                                 "matrix-prev launch")
        e = [assert_stats_close(torch, got, want, STAT_FIELDS)]
        if need_gram:
            check_gram(torch, f"{label} robust_stats_indexed", got.gram, want.gram, d)
        for cfg in (WFAggConfig(transient=3),) + ((alt_config(K),) if need_gram else ()):
            mk = lambda st: trust.derive_trust_weights(st, v, otb, cfg)[:3]  # noqa: E731
            hold_masks(torch, f"{label} robust_stats_indexed ({cfg.distance_filter})",
                       mk(got), mk(want), want, v, otb, cfg)
        errs["robust_stats_indexed[per_edge_prev]"].append(max(e))
    print(f"  {label}: per-edge prev = prev[idx] bit-identical to the matrix-prev launch "
          f"(round kernel, WFAgg and Alt-WFAgg; statistics, with and without the Gram); "
          f"an own per-edge prev: masks bit-equal to the plain versions, out max|err| "
          f"{max(errs['wfagg_round_indexed[per_edge_prev]']):.3g}, statistics max|err| "
          f"{max(errs['robust_stats_indexed[per_edge_prev]']):.3g}")
    return errs


def time_per_edge_kernels(torch, N, K, d, seed) -> dict:
    """Kernels 1 and 2 with a per-edge prev through their ``*_cuda``
    wrappers on a ring slate, beside the matrix-prev launch, their plain
    versions and bounds: the model rows the table reaches and the per-edge
    prev read once (and, for the round, ``local`` once and ``out``)."""
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.kernels.robust_stats import kernel as rk
    from repro_torch.kernels.robust_stats import ops as rops
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    idx = [[(n + o) % N for o in range(1, K + 1)] for n in range(N)]
    models, prev, idx_t, _, tb, _ = round_inputs(torch, N, K, d, idx, None, seed)
    cfg = WFAggConfig(transient=3)
    v = torch.ones((N, K), dtype=torch.bool, device="cuda")
    i32 = idx_t.to(torch.int32)
    edge = prev[idx_t.long()]
    rows = int(torch.unique(idx_t).numel())
    out = {}
    base = time_cuda(torch, lambda: rk.wfagg_round_indexed_cuda(
        models, models, i32, v, prev, tb, cfg, cfg.alpha, False), 3, 25)
    b = bound(4.0 * d * (rows + N * K + 2 * N), 16.0 * N * K * d)
    out["wfagg_round_indexed[per_edge_prev]"] = dict(
        ms=time_cuda(torch, lambda: rk.wfagg_round_indexed_cuda(
            models, models, i32, v, edge, tb, cfg, cfg.alpha, False), 3, 25),
        plain_ms=time_cuda(torch, lambda: rops.wfagg_round_indexed_plain(
            models, models, idx_t, v, cfg, edge, tb), 1, 5),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    base2 = time_cuda(torch, lambda: rk.robust_stats_indexed_cuda(
        models, i32, v, prev, False), 3, 25)
    b = bound(4.0 * d * (rows + N * K), 16.0 * N * K * d)
    out["robust_stats_indexed[per_edge_prev]"] = dict(
        ms=time_cuda(torch, lambda: rk.robust_stats_indexed_cuda(
            models, i32, v, edge, False), 3, 25),
        plain_ms=time_cuda(torch, lambda: robust_stats_indexed_ref(
            models, idx_t, v, edge), 1, 5),
        bound_ms=b[0], bound_by=b[1], library_ms=None)
    print(f"  per-edge prev N={N} K={K} d={d} ({4 * N * K * d / 2**30:.1f} GiB): with "
          f"the matrix prev read through the table the round kernel takes {base:.4f} ms "
          f"and the statistics kernel {base2:.4f} ms")
    for name, t in out.items():
        print(f"  {name} N={N} K={K} d={d}: kernel {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms ({t['bound_by']}); "
              "no single PyTorch call computes this function")
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
                if not near_ties_only(report):
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
    from repro_torch.dfl import engine

    mal = torch.as_tensor(topo.malicious, device="cuda")
    idx = torch.as_tensor(topo.neighbor_indices, device="cuda").long()
    wcfg = engine._wfagg_full_config(cfg, idx.shape[1])
    valid = torch.ones(idx.shape, dtype=torch.bool, device="cuda")
    return decision_margins(torch, wcfg, *aggregation_inputs(
        torch, cfg, data, state, idx, valid, mal), state.temporal, rec, rec_ref)


# A decision that differs from the reference's is a near-tie, and is
# reported, where the reference's own float32 value lies within this
# (relative) of a WFAgg-T band edge or of the distance filter's keep
# boundary; a similarity filter's decision has no such margin.  Phases 2
# and 3 apply this one rule.
NEAR_TIE = 1e-4


def near_ties_only(report) -> bool:
    """Whether every (node, slot, filter, margin) of ``report`` is a
    near-tie (a margin of None or NaN is not)."""
    return bool(report) and all(m is not None and m <= NEAR_TIE for _, _, _, m in report)


def decision_margins(torch, wcfg, models, idx, v, prev, prev_idx, ts, rec, rec_ref):
    """For each differing (node, slot, filter) of a round that aggregated
    ``models`` through the table ``idx`` (valid ``v``), with WFAgg-T ``prev``
    read through ``prev_idx`` (None: through ``idx``) and the pre-round
    temporal state ``ts``: the relative margin of the reference's own
    float32 value to the decision (see ``explain_dfl_round``)."""
    from repro_torch.core import trust
    from repro_torch.kernels.robust_stats.ref import robust_stats_indexed_ref

    st = robust_stats_indexed_ref(models, idx, v, prev, need_gram=True,
                                  prev_idx=prev_idx)
    tb = trust.temporal_bands(ts.hist_s, ts.hist_b, ts.count, ts.t, wcfg)
    flips = []
    for n, k in torch.nonzero(rec.verdict != rec_ref.verdict).tolist():
        diff = int(rec.verdict[n, k] ^ rec_ref.verdict[n, k])
        flips += [(n, k, bit) for bit in range(3) if (diff >> bit) & 1]
    return flip_margins(torch, st, v, tb, wcfg, flips)


def flip_margins(torch, st, v, tb, wcfg, flips):
    """(node, slot, filter, margin) for each (node, slot, bit) of ``flips``
    (bit 0 the distance filter, 1 the similarity filter, 2 WFAgg-T): the
    relative margin of the reference's own float32 statistics ``st`` to the
    decision under the WFAgg-T bands ``tb`` (N, 4K), valid slots ``v``;
    None where no margin is defined."""
    from repro_torch.core import aggregators as agg
    from repro_torch.core import trust

    K = v.shape[1]
    rel = lambda x, e: float(((x - e).abs() / x.abs().clamp(min=1e-30)).item())  # noqa: E731
    if wcfg.distance_filter == "multi_krum":
        d2 = trust.sq_dists_from_gram(st.gram)
        vp = v[:, :, None] & v[:, None, :]
        scores = agg.krum_scores_from_sq_dists_dyn(torch.where(vp, d2, torch.inf),
                                                   wcfg.f, v.sum(-1))
        keep = torch.clamp(v.sum(-1), max=trust.multi_krum_m(wcfg, K))
    else:
        scores, keep = st.dist2, v.sum(-1) - wcfg.f - 1
    scores = torch.where(v, scores, torch.inf)
    report = []
    for n, k, bit in flips:
        margin = None
        if bit == 2:
            s_t, b_t = st.prev_dist2[n, k], st.cosine_to_prev()[n, k]
            margin = min(rel(s_t, tb[n, k]), rel(s_t, tb[n, K + k]),
                         rel(b_t, tb[n, 2 * K + k]), rel(b_t, tb[n, 3 * K + k]))
        elif bit == 0 and 0 < int(keep[n]) < int(v[n].sum()):
            srt = torch.sort(scores[n]).values
            margin = rel(srt[int(keep[n])], srt[int(keep[n]) - 1])
        report.append((n, k, ("distance", "similarity", "WFAgg-T")[bit], margin))
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


# ---------------------------------------------------------------------------
# phase 3: dynamic topologies and chaos transport
# ---------------------------------------------------------------------------

def upload_schedule(torch, sched, fs=None):
    """The schedule's stacks on the card: (idx, valid, malicious[, drop, lag,
    dup, corrupt, down])."""
    import numpy as np

    xs = tuple(torch.as_tensor(np.asarray(a), device="cuda")
               for a in (sched.neighbor_idx, sched.valid, sched.malicious))
    return xs + (fs.xs("cuda") if fs is not None else ())


def aggregation_inputs(torch, cfg, data, state, idx, val, mal, ts=None, fr=None,
                       fcfg=None):
    """What a round (a chaos round with ``ts``/``fr``) hands the WFAgg
    aggregation after its sanitizer, from the engine's own steps before
    it: ``(models, table, valid, prev, prev_idx)``."""
    from repro_torch.core import wfagg as wf
    from repro_torch.dfl import engine

    if ts is None:
        _, _, flat = engine._trained(cfg, data, state, mal)
        models, v = wf.sanitize_rows(flat, idx.long(), val)
        return models, idx.long(), v, state.temporal.prev, None
    tout = engine.chaos_inputs(cfg, data, fcfg, state, idx, val, mal, ts, fr).tout
    models, v = wf.sanitize_rows(tout.full, tout.eff_idx, tout.eff_valid)
    return models, tout.eff_idx, v, models, tout.prev_idx


def check_dynamic_against_reference(torch, cfg, topo, data, sched, fs=None):
    """Replay a dynamic (with ``fs``, chaos) run round by round: from each
    of its states, realigned to the round's slate, one round on the run's
    backend and one on the reference backend (deterministic cuDNN) must
    give bit-equal verdicts and models within 3e-5; a differing verdict
    within 1e-4 (relative) of a band edge or keep boundary is reported
    with its margin, any other difference fails (as
    ``check_against_reference``)."""
    import dataclasses

    from repro_torch.dfl import engine
    from repro_torch.dfl import faults as flt
    from repro_torch.models.lenet import ravel

    fcfg = fs.config if fs is not None else None
    fns = [engine.build_round_fn(c, topo, data, dynamic=True, telemetry=True,
                                 faults=fcfg, device="cuda")
           for c in (cfg, dataclasses.replace(cfg, wfagg_backend="reference"))]
    state = engine.init_dfl_state(cfg, topo, degree=sched.width, device="cuda")
    xs = upload_schedule(torch, sched, fs)
    ts = (flt.init_transport_state(fcfg, topo.n_nodes, sched.width,
                                   ravel(state.node_params).shape[1], device="cuda")
          if fs is not None else None)
    label = f"{cfg.aggregator} on {cfg.wfagg_backend}" + (" under chaos" if fs else "")
    prev = (xs[0][0], xs[1][0])
    torch.backends.cudnn.deterministic = True
    try:
        edge_rounds, t_fired = [], 0
        for r in range(sched.rounds):
            idx, val, mal = (x[r] for x in xs[:3])
            state, ts = engine.realign_to_slate(state, ts, *prev, idx, val)
            fr = flt.FaultRound(*(x[r] for x in xs[3:])) if fs is not None else None
            args = (state, idx, val, mal) + ((ts, fr) if fs is not None else ())
            (nxt, *rest), (alt, *rest_ref) = fns[0](*args), fns[1](*args)
            rec, rec_ref = rest[-1], rest_ref[-1]
            flat = ravel(nxt.node_params)
            if not torch.isfinite(flat[torch.as_tensor(~sched.malicious.any(0),
                                                       device="cuda")]).all():
                raise AssertionError(f"{label} round {r + 1}: a benign model is not finite")
            if not torch.equal(rec.verdict, rec_ref.verdict):
                inputs = aggregation_inputs(torch, cfg, data, state, idx, val, mal, ts,
                                            fr, fcfg)
                wcfg = engine._wfagg_full_config(cfg, sched.width)
                report = decision_margins(torch, wcfg, *inputs, state.temporal, rec,
                                          rec_ref)
                print(f"  {label} round {r + 1}: verdicts differ from the reference "
                      f"backend: (node, slot, filter, margin) {report}")
                if not near_ties_only(report):
                    raise AssertionError(f"{label} round {r + 1}: verdicts differ from the "
                                         "reference backend away from any edge")
                edge_rounds.append((r + 1, report))
            else:
                torch.testing.assert_close(flat, ravel(alt.node_params), rtol=OUT_TOL,
                                           atol=OUT_TOL, equal_nan=True)
            t_fired += int(((rec.verdict >> 2) & 1).sum())
            state, ts = nxt, (rest[0] if fs is not None else None)
            prev = (idx, val)
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"  {label} == the reference backend on the card, {sched.rounds} rounds: "
          f"verdicts bit-equal and models within {OUT_TOL} in "
          f"{sched.rounds - len(edge_rounds)} rounds (rounds on an edge: {edge_rounds}); "
          f"WFAgg-T accepted {t_fired} edges")
    return edge_rounds


def check_no_host_sync(torch, cfg, topo, data, sched, fs=None):
    """One dynamic (with ``fs``, chaos) round, re-keying included, under
    ``torch.cuda.set_sync_debug_mode("error")``: any operation that makes
    the host wait on the card raises."""
    from repro_torch.dfl import engine
    from repro_torch.dfl import faults as flt
    from repro_torch.models.lenet import ravel

    fcfg = fs.config if fs is not None else None
    fn = engine.build_round_fn(cfg, topo, data, dynamic=True, faults=fcfg, device="cuda")
    state = engine.init_dfl_state(cfg, topo, degree=sched.width, device="cuda")
    xs = upload_schedule(torch, sched, fs)
    ts = (flt.init_transport_state(fcfg, topo.n_nodes, sched.width,
                                   ravel(state.node_params).shape[1], device="cuda")
          if fs is not None else None)
    prev = (xs[0][0], xs[1][0])
    for r in range(2):       # round 0 warms up (kernel libraries, allocator)
        torch.cuda.synchronize()
        if r == 1:
            torch.cuda.set_sync_debug_mode("error")
        try:
            idx, val, mal = (x[r] for x in xs[:3])
            state, ts = engine.realign_to_slate(state, ts, *prev, idx, val)
            if fs is None:
                state = fn(state, idx, val, mal)
            else:
                state, ts = fn(state, idx, val, mal, ts,
                               flt.FaultRound(*(x[r] for x in xs[3:])))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        prev = (idx, val)
    torch.cuda.synchronize()
    print(f"  {cfg.aggregator} on {cfg.wfagg_backend}" + (" under chaos" if fs else "")
          + ": one round ran under set_sync_debug_mode('error') with no host sync")


def check_kill_and_resume(torch, cfg, topo, data, sched, fs, stop):
    """Stop a chaos run after ``stop`` rounds, checkpoint, resume, finish:
    every array of the final carry (models, momentum, the WFAgg-T ring
    buffers and prev, the transport ring and served-lag table, the slate,
    the round counter) and the schedules are ``torch.equal`` to those of
    the uninterrupted run, and so are the accuracy series."""
    import tempfile

    import numpy as np

    from repro_torch.dfl.engine import run_dynamic_experiment

    run = lambda **kw: run_dynamic_experiment(cfg, topo, data, sched, faults=fs,  # noqa: E731
                                              device="cuda", **kw)
    torch.backends.cudnn.deterministic = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            full = run(checkpoint_dir=f"{tmp}/full")
            part = run(stop_after=stop, checkpoint_dir=f"{tmp}/snap")
            resumed = run(resume_from=f"{tmp}/snap", checkpoint_dir=f"{tmp}/resumed")
            with np.load(f"{tmp}/full/chaos.npz") as a, \
                    np.load(f"{tmp}/resumed/chaos.npz") as b:
                if sorted(a.files) != sorted(b.files):
                    raise AssertionError("kill-and-resume: the carries differ in structure")
                differ = [k for k in a.files
                          if not torch.equal(torch.from_numpy(a[k]), torch.from_numpy(b[k]))]
                keys = a.files
    finally:
        torch.backends.cudnn.deterministic = False
    if differ:
        raise AssertionError(f"kill-and-resume: {differ} differ from the uninterrupted run")
    series = part["series"]["acc_benign_mean"] + resumed["series"]["acc_benign_mean"]
    if series != full["series"]["acc_benign_mean"] or \
            resumed["rounds_run"] != [stop, sched.rounds]:
        raise AssertionError("kill-and-resume: the stitched series differ")
    ring = [k for k in keys if "ring" in k or "served_lag" in k or "hist" in k]
    print(f"  kill-and-resume ({cfg.aggregator}, {cfg.attack}, stop after {stop} of "
          f"{sched.rounds} rounds): all {len(keys)} arrays of the final carry and "
          f"schedules torch.equal to the uninterrupted run's (among them {ring}); "
          "stitched accuracy series equal")


def run_dynamic_paths(torch, topo, data) -> dict:
    """Phase 3's dynamic and chaos paths: each run with every launch count
    set to 0 just before and read just after, replayed against the
    reference backend; a round under the sync check; kill-and-resume;
    finite series under corruption; benign accuracy under chaos (printed
    only).  Returns the launches of the runs by kernel."""
    import numpy as np

    from repro_torch.core.topology import paper_topology
    from repro_torch.dfl.dynamics import make_faulty_schedule, make_schedule
    from repro_torch.dfl.engine import DFLConfig, run_dynamic_experiment

    total = dict.fromkeys(KERNELS, 0)
    sched = make_schedule("churn", topo, ROUNDS, seed=1)
    fsched, fs = make_faulty_schedule("churn", topo, ROUNDS, fault="chaos", intensity=0.4)
    print(f"  churn: degree min/mean/max per round "
          f"{[[round(float(x), 2) for x in row] for row in sched.degree_stats()]}; chaos "
          f"schedule {fs.summary()}")
    runs = [("wfagg", "fused", None), ("wfagg", "fused", fs), ("alt_wfagg", "fused", fs),
            ("wfagg", "fused_two_launch", fs), ("mean", "fused", fs),
            ("median", "fused", None), ("multi_krum", "fused", None),
            ("median", "fused", fs), ("multi_krum", "fused", fs)]
    for agg, backend, faults in runs:
        cfg = DFLConfig(aggregator=agg, attack="ipm_100", model="lenet",
                        wfagg_backend=backend)
        s = fsched if faults is not None else sched
        zero_counts()
        o = run_dynamic_experiment(cfg, topo, data, s, faults=faults)
        counts = read_counts()
        want = dict.fromkeys(KERNELS, 0)
        wfagg = agg in ("wfagg", "alt_wfagg")
        if wfagg and backend == "fused":
            want["wfagg_round_indexed"] = ROUNDS
            want["wfagg_round_indexed[prev_idx]"] = ROUNDS if faults is not None else 0
        elif wfagg:
            want["robust_stats_indexed"] = want["weighted_agg_indexed"] = ROUNDS
            want["robust_stats_indexed[prev_idx]"] = ROUNDS
        label = (f"{agg} on {backend}" if wfagg else agg) + (
            " under chaos" if faults is not None else " under churn")
        if counts != want:
            raise AssertionError(f"{label}: launches {counts}, expected {want}")
        if not all(np.isfinite(e["acc_all"]).all() for e in o["trace"]):
            raise AssertionError(f"{label}: non-finite accuracy")
        print(f"  {label}: launches {dict((k, v) for k, v in counts.items() if v)}; "
              f"benign acc per round {[round(a, 4) for a in o['series']['acc_benign_mean']]}"
              f", round ms {[round(1e3 * t, 2) for t in o['series']['round_seconds']]}")
        for name in KERNELS:
            total[name] += counts[name]
        if wfagg:
            check_dynamic_against_reference(torch, cfg, topo, data, s, faults)
    for agg, backend, faults in runs[:2] + runs[3:4]:
        check_no_host_sync(torch, DFLConfig(aggregator=agg, attack="ipm_100",
                                            model="lenet", wfagg_backend=backend),
                           topo, data, fsched if faults is not None else sched, faults)
    check_kill_and_resume(torch, DFLConfig(aggregator="wfagg", attack="alie",
                                           model="lenet"), topo, data, fsched, fs, stop=3)

    mlp_topo = paper_topology()
    csched, cfs = make_faulty_schedule("churn", mlp_topo, 3, fault="corrupt",
                                       intensity=0.5, seed=1, fault_seed=2)
    for agg in ("wfagg", "mean", "median"):
        o = run_dynamic_experiment(DFLConfig(aggregator=agg, attack="none", model="mlp"),
                                   mlp_topo, data, csched, faults=cfs)
        s = o["series"]
        if not (np.isfinite(s["acc_benign_mean"]).all() and np.isfinite(s["r_squared"]).all()
                and np.isfinite(o["final"]["acc_benign_mean"])):
            raise AssertionError(f"{agg} under corrupt@0.5: a series is not finite")
        print(f"  {agg} under corrupt@0.5 (MLP, 3 rounds, corrupt rate "
              f"{o['faults']['corrupt_rate']:.3f}): every series finite, benign acc "
              f"{[round(a, 4) for a in s['acc_benign_mean']]}")
    asched, afs = make_faulty_schedule("churn", mlp_topo, ROUNDS, fault="chaos",
                                       intensity=0.4)
    for agg in ("wfagg", "mean"):
        o = run_dynamic_experiment(DFLConfig(aggregator=agg, attack="ipm_100", model="mlp"),
                                   mlp_topo, data, asched, faults=afs)
        print(f"  {agg} under churn + chaos@0.4, IPM-100 (MLP, {ROUNDS} rounds; printed "
              f"only, the reference states no claim): benign acc per round "
              f"{[round(a, 4) for a in o['series']['acc_benign_mean']]}")
    return total


# ---------------------------------------------------------------------------
# phase 3: the gathered wfagg_batch, Table I, the padded baselines
# ---------------------------------------------------------------------------

def verdicts(torch, info):
    """The per-edge verdict bits of ``obs.decision`` from a ``wfagg_batch``
    info dict: distance, similarity, WFAgg-T."""
    import types

    bits = (info["mask_d"].to(torch.int32) | (info["mask_c"].to(torch.int32) << 1)
            | (info["mask_t"].to(torch.int32) << 2))
    return types.SimpleNamespace(verdict=bits)


def run_gathered_path(torch, topo, data) -> dict:
    """The gathered ``wfagg_batch`` over the paper's DFL rounds (LeNet-5,
    IPM-100, ``ROUNDS`` rounds), WFAgg and Alt-WFAgg on ``fused`` with the
    per-edge WFAgg-T state carried round to round: each round's input is
    each node's K received models gathered from the round's trained and
    attacked matrix (``engine._trained`` on the engine's own state, which
    the engine's round then advances, as ``aggregation_inputs`` builds
    it).  Every round also runs, from the same models and state, the
    gathered ``reference`` backend and the indexed ``fused`` and
    ``fused_two_launch`` paths fed the per-edge state; each call has its
    launch counts set to 0 just before and read just after (exactly one
    kernel-5 launch on the gathered ``fused`` call; the per-edge variants
    of kernels 1 and 2 on the indexed calls; none on the reference).  Masks
    must be equal, or the round is reported with its filter and margin (as
    ``check_against_reference``); outputs within 3e-5.  A node that
    received a non-finite row (the attackers' rows, once their own models
    diverge; the gathered form has no sanitizer, as in the reference) is
    compared with ``equal_nan`` against the gathered reference and
    reported; the indexed paths, which sanitize, are held to the finite
    nodes.  Returns the launches by kernel."""
    import dataclasses

    from repro_torch.core import wfagg as wf
    from repro_torch.dfl import engine
    from repro_torch.models.lenet import ravel

    idx = torch.as_tensor(topo.neighbor_indices, device="cuda").long()
    N, K = idx.shape
    mal = torch.as_tensor(topo.malicious, device="cuda")
    total = dict.fromkeys(KERNELS, 0)
    for agg in ("wfagg", "alt_wfagg"):
        cfg = engine.DFLConfig(aggregator=agg, attack="ipm_100", model="lenet")
        wcfg = engine._wfagg_full_config(cfg, K, backend="fused")
        ref, two = (dataclasses.replace(wcfg, backend=b)
                    for b in ("reference", "fused_two_launch"))
        state = engine.init_dfl_state(cfg, topo)
        advance = engine.build_round_fn(cfg, topo, data)
        d = ravel(state.node_params).shape[1]
        ts = wf.TemporalState(
            prev=torch.zeros((N, K, d), device="cuda"),
            hist_s=torch.zeros((N, wcfg.window, K), device="cuda"),
            hist_b=torch.zeros((N, wcfg.window, K), device="cuda"),
            count=torch.zeros((N,), dtype=torch.int32, device="cuda"),
            t=torch.zeros((N,), dtype=torch.int32, device="cuda"))
        # name -> (call on (flat, gathered, state), its exact launches)
        calls = {
            "gathered fused": (lambda flat, u, st: wf.wfagg_batch(flat, u, st, wcfg),
                               {"robust_stats_batch": 1}),
            "gathered reference": (lambda flat, u, st: wf.wfagg_batch(flat, u, st, ref),
                                   {}),
            "indexed fused": (lambda flat, u, st: wf.wfagg_batch(
                flat, flat, st, wcfg, neighbor_idx=idx),
                {"wfagg_round_indexed": 1, "wfagg_round_indexed[per_edge_prev]": 1}),
            "indexed fused_two_launch": (lambda flat, u, st: wf.wfagg_batch(
                flat, flat, st, two, neighbor_idx=idx),
                {"robust_stats_indexed": 1, "robust_stats_indexed[per_edge_prev]": 1,
                 "weighted_agg_indexed": 1}),
        }
        seconds, edges, nonfinite, t_fired = [], [], [], 0
        for r in range(ROUNDS):
            flat = engine._trained(cfg, data, state, mal)[2]
            u = flat[idx]
            res = {}
            for name, (fn, want) in calls.items():
                zero_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res[name] = fn(flat, u, ts)
                torch.cuda.synchronize()
                if name == "gathered fused":
                    seconds.append(time.perf_counter() - t0)
                counts = read_counts()
                want = dict(dict.fromkeys(KERNELS, 0), **want)
                if counts != want:
                    raise AssertionError(f"gathered path {agg} round {r + 1} {name}: "
                                         f"launches {counts}, expected {want}")
                for k in KERNELS:
                    total[k] += counts[k]
            out, nts, info = res["gathered fused"]
            bad = ~(torch.isfinite(u).all(-1).all(-1) & torch.isfinite(ts.prev).all(-1).all(-1))
            nonfinite.append(torch.nonzero(bad).flatten().tolist())
            rec = verdicts(torch, info)
            for name in ("gathered reference", "indexed fused", "indexed fused_two_launch"):
                o, st, inf = res[name]
                rec_ref = verdicts(torch, inf)
                differ = rec.verdict != rec_ref.verdict
                if name != "gathered reference":
                    differ &= ~bad[:, None]       # the sanitizer acts on these nodes
                if differ.any():
                    report = decision_margins(
                        torch, wcfg, flat, idx, torch.ones((N, K), dtype=torch.bool,
                                                          device="cuda"),
                        ts.prev, None, ts, rec, rec_ref)
                    report = [x for x in report if bool(differ[x[0], x[1]])]
                    print(f"  gathered {agg} round {r + 1}: verdicts differ from the "
                          f"{name} path: (node, slot, filter, margin) {report}")
                    if not near_ties_only(report):
                        raise AssertionError(f"gathered {agg} round {r + 1}: verdicts "
                                             f"differ from the {name} path away from "
                                             "any edge")
                    edges.append((r + 1, name, report))
                    continue
                if name == "gathered reference":
                    torch.testing.assert_close(out, o, rtol=OUT_TOL, atol=OUT_TOL,
                                               equal_nan=True)
                else:
                    torch.testing.assert_close(out[~bad], o[~bad], rtol=OUT_TOL,
                                               atol=OUT_TOL)
                    if not torch.equal(st.prev[~bad], u[~bad]):
                        raise AssertionError(f"gathered {agg} round {r + 1}: the {name} "
                                             "path's per-edge state is not models[idx]")
            if not same_bits(torch, nts.prev, u):
                raise AssertionError(f"gathered {agg}: the new per-edge state is not "
                                     "the round's gathered tensor")
            t_fired += int(info["mask_t"][~bad].sum())
            ts = nts
            state = advance(state)
        print(f"  gathered {agg} on fused, {ROUNDS} rounds: verdicts equal to the gathered "
              f"reference and the indexed fused / fused_two_launch paths with per-edge "
              f"state, outputs within {OUT_TOL} (rounds on an edge: {edges}); WFAgg-T "
              f"accepted {t_fired} edges of finite nodes; nodes with a non-finite "
              f"candidate or prev per round {nonfinite}; gathered fused aggregation ms "
              f"{[round(1e3 * s_, 3) for s_ in seconds]}")
        if t_fired == 0:
            raise AssertionError(f"gathered {agg}: the WFAgg-T band test never fired")
    return total


def run_table1(torch, data) -> tuple:
    """Table I on the MLP (paper topology, IPM-100, 4 rounds): all 12
    aggregators in DFL and in CFL through ``run_experiment``, each with
    the launch counts set to 0 just before and read just after (the kernels
    run only under WFAgg and Alt-WFAgg: one round kernel per DFL round; one
    statistics and one combine launch, and for Alt-WFAgg one Gram, per CFL
    round).  Returns (final benign accuracy by (aggregator, centralized),
    launches by kernel)."""
    import numpy as np

    from repro_torch.core.topology import paper_topology
    from repro_torch.dfl.engine import AGGREGATORS, DFLConfig, run_experiment

    accs, total, rows = {}, dict.fromkeys(KERNELS, 0), []
    for centralized in (False, True):
        for agg in AGGREGATORS:
            cfg = DFLConfig(aggregator=agg, attack="ipm_100", model="mlp",
                            centralized=centralized)
            zero_counts()
            o = run_experiment(cfg, paper_topology(), data, rounds=4, eval_every=4)
            counts = read_counts()
            want = dict.fromkeys(KERNELS, 0)
            if agg in ("wfagg", "alt_wfagg") and not centralized:
                want["wfagg_round_indexed"] = 4
            elif agg in ("wfagg", "alt_wfagg"):
                want["robust_stats"] = want["weighted_agg"] = 4
                want["pairwise_gram"] = 4 if agg == "alt_wfagg" else 0
            label = f"{'CFL' if centralized else 'DFL'} {agg}"
            if counts != want:
                raise AssertionError(f"Table I {label}: launches {counts}, expected {want}")
            if not all(np.isfinite(e["acc_all"]).all() for e in o["trace"]):
                raise AssertionError(f"Table I {label}: non-finite accuracy")
            for k in KERNELS:
                total[k] += counts[k]
            accs[(agg, centralized)] = o["final"]["acc_benign_mean"]
            ms = "/".join(str(round(1e3 * t, 1)) for t in o["series"]["round_seconds"])
            rows.append(f"{agg} {accs[(agg, centralized)]:.4f} ({ms} ms)")
        print(f"  Table I, {'CFL' if centralized else 'DFL'} (MLP, IPM-100, 4 rounds; "
              f"final benign acc, round ms): " + "; ".join(rows))
        rows = []
    return accs, total


# ---------------------------------------------------------------------------
# phase 2: kernel 8, flash attention

FLASH_F32_TOL = 2e-5   # tests/test_kernels.py:230
# kernel 8's bf16 o against its plain version: both accumulate in f32 and
# round o once, so they differ by at most one bf16 step (2^-8 to 2^-7 of
# the value); m and l are f32 in both, held at the f32 tolerance.  The
# reference's 2e-2 was set at Sk <= 384, where |o| ~ 0.1 and more; at
# Sk = 8192 a typical |o| is 0.02-0.03, and 2e-2 would pass almost anything
O_BF16_RTOL, O_BF16_ATOL = 2.0 ** -7, 1e-5
# logits (bf16, |logit| up to ~4 on the seed-0 init) of two routes of the
# same model: relative rms and largest difference (8 bf16 steps at 2-4).
# A top-1 that differs where the top-2 margin is 2 * LOGIT_ATOL or more
# cannot come from differences within LOGIT_ATOL
LOGIT_RMS, LOGIT_ATOL = 2e-2, 0.125
PREFILL_TAIL = 256   # positions of each prompt whose logits are compared
# (B, H, Sq, Sk, hd, causal, dtype, block): the six cases of
# tests/test_kernels.py:209-216 (block 64, as there), Sq > Sk (rows with no
# live key), hd 80 and 128 with ragged padding; the same branches of the bf16
# tensor-core kernel (hd 32 ragged, Sq > Sk, Sk not a multiple of its 64-key
# tile, hd 128 non-causal); then the prefill's attention at Qwen1.5-0.5B width
# (2 prompts of 8192 tokens, 16 heads of 64)
FLASH_CASES = [
    (1, 2, 128, 128, 64, True, "float32", 64),
    (2, 1, 256, 256, 32, True, "float32", 64),
    (1, 1, 128, 384, 64, True, "float32", 64),
    (1, 2, 130, 200, 32, True, "float32", 64),
    (1, 1, 128, 256, 64, False, "float32", 64),
    (1, 2, 128, 128, 64, True, "bfloat16", 64),
    (1, 2, 256, 128, 64, True, "float32", 128),
    (1, 2, 256, 100, 80, True, "bfloat16", 128),
    (2, 3, 300, 300, 80, True, "float32", 128),
    (2, 2, 200, 333, 128, False, "float32", 128),
    (1, 4, 256, 512, 128, True, "bfloat16", 128),
    (1, 2, 130, 200, 32, True, "bfloat16", 64),
    (1, 2, 256, 128, 64, True, "bfloat16", 128),
    (2, 3, 300, 300, 80, True, "bfloat16", 128),
    (2, 2, 200, 333, 128, False, "bfloat16", 128),
    (1, 1, 128, 256, 64, False, "bfloat16", 64),
    (2, 16, 8192, 8192, 64, True, "bfloat16", 128),
    (2, 16, 8192, 8192, 64, True, "float32", 128),
]
SERVE_ARCH = "qwen1.5-0.5b"
PREFILL_B, PREFILL_S, PREFILL_REPS = 2, 8192, 3
DECODE_B, PROMPT, NEW_TOKENS = 4, 64, 32


def flash_inputs(torch, BH, Sq, Sk, hd, dtype, seed):
    """Unit-normal q (BH, Sq, hd), k and v (BH, Sk, hd) in ``dtype``."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn((BH, S, hd), generator=g, device="cuda").to(getattr(torch, dtype))
                 for S in (Sq, Sk, Sk))


def _hold(label, name, got, want, dtype) -> tuple:
    """One output of kernel 8 against its plain version: o in bf16 within
    one rounding, o in f32 and m and l (f32) within 2e-5.  Returns the
    largest absolute and the relative rms difference."""
    import torch

    a, b = got.float(), want.float()
    if name == "o" and dtype == "bfloat16":
        rtol, atol = O_BF16_RTOL, O_BF16_ATOL
    else:
        rtol = atol = FLASH_F32_TOL
    err = float((a - b).abs().max())
    rel = float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt().clamp_min(1e-30))
    if not torch.allclose(a, b, rtol=rtol, atol=atol):
        raise AssertionError(f"flash_attention {label}: {name} differs from the plain "
                             f"version by {err} (rtol {rtol}, atol {atol})")
    return err, rel


def compare_flash(torch, B, H, Sq, Sk, hd, causal, dtype, block, seed) -> float:
    """Kernel 8 against its plain version, twice: through the wrapper the
    prefill calls (``ops.flash_attention`` on (B, H, S, hd) views, which
    passes ``sk_valid = Sk`` and ``q_offset = Sk - Sq``), o only; and at
    kernel level on the reference's layout, Sq and Sk padded to ``block``
    (the padding masked through ``sk_valid``), o, m and l.  The rows with
    no live key are exactly o = 0, m = -1e30, l = 0 in both.  Returns o's
    largest absolute difference."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.flash_attn import ops as fops
    from repro_torch.kernels.flash_attn.ref import NEG_INF, flash_attention_plain

    q, k, v = flash_inputs(torch, B * H, Sq, Sk, hd, dtype, seed)
    args = (float(1.0 / hd ** 0.5), causal, Sk, Sk - Sq)
    tc_before = fk.launches_tc
    label = f"B={B} H={H} Sq={Sq} Sk={Sk} hd={hd} causal={causal} {dtype}"
    want = flash_attention_plain(q, k, v, *args)
    o4 = fops.flash_attention(q.view(B, H, Sq, hd), k.view(B, H, Sk, hd),
                              v.view(B, H, Sk, hd), args[0], causal)
    wrapper = _hold(label + " (ops.flash_attention)", "o", o4.reshape(B * H, Sq, hd),
                    want[0], dtype)
    pq, pk = (-Sq) % block, (-Sk) % block
    if pq or pk:
        q = F.pad(q, (0, 0, 0, pq))
        k, v = (F.pad(t, (0, 0, 0, pk)) for t in (k, v))
        want = flash_attention_plain(q, k, v, *args)
    got = fk.flash_attention_cuda(q, k, v, *args)
    torch.cuda.synchronize()
    tc = fk.launches_tc - tc_before
    if tc != (2 if dtype == "bfloat16" else 0):
        raise AssertionError(f"flash_attention {label}: {tc} tensor-core launches of 2 calls")
    errs = {name: _hold(label, name, a, b, dtype) for name, a, b in zip("oml", got, want)}
    dead = torch.arange(q.shape[1], device="cuda") + (Sk - Sq) < 0
    if not causal:
        dead[:] = False
    for o, m, l in (got, want):
        if not (bool((o[:, dead] == 0).all()) and bool((m[:, dead] == NEG_INF).all())
                and bool((l[:, dead] == 0).all())):
            raise AssertionError(f"flash_attention {label}: a row with no live key is "
                                 "not exactly o = 0, m = -1e30, l = 0")
    steps = ""
    if dtype == "bfloat16":
        # elements of o a bf16 step or more off the plain version, beside
        # the same count for the kernel's arithmetic emulated in plain
        # PyTorch (p as P_TERMS bf16 terms, exact products summed in f32)
        emu = flash_attention_plain(q, k, v, *args, p_terms=fk.P_TERMS)[0]
        steps = (f", {int((got[0] != want[0]).sum())} of {got[0].numel()} bf16 o differ "
                 f"(the {fk.P_TERMS}-term emulation: {int((emu != want[0]).sum())})")
        del emu
    print(f"  flash_attention {label}: through ops.flash_attention max |o - plain| "
          f"{wrapper[0]:.3g} (relative rms {wrapper[1]:.3g}); padded to {block}: max |o - "
          f"plain| {errs['o'][0]:.3g} (relative rms {errs['o'][1]:.3g}), m "
          f"{errs['m'][0]:.3g}, l {errs['l'][0]:.3g}{steps}; {int(dead.sum())} rows with no "
          "live key, exact")
    return max(wrapper[0], errs["o"][0])


def time_flash(torch, B, H, S, hd, seed) -> dict:
    """Kernel 8 at the prefill's attention shape (causal, Sq = Sk = S) in
    bf16, the main path's type (the tensor-core kernel; and in f32, the
    CUDA-core kernel, printed): kernel, plain version, bound and
    ``F.scaled_dot_product_attention``.  The bound counts 4*hd operations
    per live pair at the type's rate: bf16 on the tensor cores (whose
    products are exact in f32, as the reference's), f32 on the CUDA cores
    (TF32 off)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attn import kernel as fk
    from repro_torch.kernels.flash_attn.ref import flash_attention_plain

    scale = float(1.0 / hd ** 0.5)
    live = B * H * S * (S + 1) / 2          # causal (query, key) pairs
    out = {}
    for dtype in ("bfloat16", "float32"):
        q, k, v = flash_inputs(torch, B * H, S, S, hd, dtype, seed)
        size = q.element_size()
        b = bound(4.0 * B * H * S * hd * size + 8.0 * B * H * S, 4.0 * hd * live,
                  BF16_TC_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S)
        q4, k4, v4 = (t.view(B, H, S, hd) for t in (q, k, v))
        out[dtype] = dict(
            ms=time_cuda(torch, lambda: fk.flash_attention_cuda(q, k, v, scale, True, S, 0),
                         2, 10),
            plain_ms=time_cuda(torch, lambda: flash_attention_plain(q, k, v, scale, True,
                                                                    S, 0), 1, 3),
            bound_ms=b[0], bound_by=b[1],
            library_ms=time_cuda(torch, lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True), 3, 20))
        t = out[dtype]
        print(f"  flash_attention B={B} H={H} S={S} hd={hd} causal {dtype}: kernel "
              f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}), F.scaled_dot_product_attention {t['library_ms']:.4f} ms; "
              f"{4.0 * hd * live / t['ms'] / 1e9:.2f} TFLOP/s")
    return dict(out["bfloat16"], shape=f"B={B} H={H} S={S} hd={hd} causal bf16",
                f32=out["float32"])


def check_flash_refusals(torch) -> None:
    """No fallback on the card: a bf16 call the tensor-core kernel cannot
    take (a pointer off 16 bytes, a head dim it has no instance for)
    raises before any launch; it is never copied or sent to the f32 kernel
    or the plain version."""
    from repro_torch.kernels.flash_attn import kernel as fk

    before = (fk.launches, fk.launches_tc)
    q = torch.zeros(2 * 64 * 64 + 1, dtype=torch.bfloat16, device="cuda")[1:].view(2, 64, 64)
    for label, args in (("misaligned q", (q, q.clone(), q.clone())),
                        ("hd 48", (torch.zeros((2, 64, 48), dtype=torch.bfloat16,
                                               device="cuda"),) * 3)):
        try:
            fk.flash_attention_cuda(*args, 0.125, True, 64, 0)
        except ValueError as e:
            print(f"  flash_attention bf16 {label}: refused ({e})")
        else:
            raise AssertionError(f"flash_attention bf16 {label}: ran instead of raising")
    if (fk.launches, fk.launches_tc) != before:
        raise AssertionError("a refused flash_attention call launched a kernel")


def check_flash(torch) -> tuple:
    """Phase 2 for kernel 8: every case of ``FLASH_CASES``, the refusals,
    then the times at the prefill's shape.  Returns (o's errors, times)."""
    errs = [compare_flash(torch, *case, seed=60 + i) for i, case in enumerate(FLASH_CASES)]
    check_flash_refusals(torch)
    return errs, time_flash(torch, PREFILL_B, 16, PREFILL_S, 64, seed=80)


# ---------------------------------------------------------------------------
# phase 3: serving Qwen1.5-0.5B (prefill through kernel 8, KV-cache decode)


def check_logits(torch, label, got, want) -> None:
    """Two logit sets (..., V) of one model on two routes: relative rms
    within ``LOGIT_RMS``, largest difference within ``LOGIT_ATOL``, and
    top-1 tokens equal except at near-ties, positions whose top-2 margin
    in ``want`` is below 2 * ``LOGIT_ATOL`` (the most that differences
    within ``LOGIT_ATOL`` can flip), reported with their margin."""
    d = got - want
    rel = float(d.pow(2).mean().sqrt() / want.pow(2).mean().sqrt())
    biggest = float(d.abs().max())
    top2 = want.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    differ = got.argmax(-1) != want.argmax(-1)
    print(f"  {label}: largest logit difference {biggest:.4g} (logits up to "
          f"{float(want.abs().max()):.4g}), relative rms {rel:.3g}; top-1 differs at "
          f"{int(differ.sum())} of {differ.numel()} positions")
    if rel > LOGIT_RMS or biggest > LOGIT_ATOL:
        raise AssertionError(f"{label}: relative rms {rel} (bound {LOGIT_RMS}), largest "
                             f"difference {biggest} (bound {LOGIT_ATOL})")
    if bool((differ & (margin >= 2 * LOGIT_ATOL)).any()):
        raise AssertionError(f"{label}: top-1 differs where the top-2 margin is "
                             f"{2 * LOGIT_ATOL} or more")
    for i in differ.nonzero().tolist()[:8]:
        print(f"  {label}: near-tie at {i}: top-2 margin {float(margin[tuple(i)]):.4g}")


def run_serve_path(torch) -> dict:
    """Phase 3's serving path at full Qwen1.5-0.5B width and depth on the
    port's own init (seed 0): ``build_prefill`` on 2 prompts x 8192 tokens
    (warm once, then timed; 24 kernel-8 launches per call), the same
    prompts with ``flash=False``, ``build_decode_step`` at batch 4 against
    a cache of ``decode_32k``'s 32,768 positions (a 64-token prompt, then
    32 greedy tokens; no kernel), and the stepped logits against one
    prefill of the same 96 tokens.  Returns launches by kernel, and kernel
    8's on the bf16 tensor-core kernel as ``flash_attention[tensor_core]``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import DECODE_32K
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.train.serve import build_decode_step, build_prefill

    cfg = get_config(SERVE_ARCH)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
          f"of {cfg.head_dim_}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {n_params} f32 "
          f"parameters, initialised in {time.perf_counter() - t0:.2f} s")
    g = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S), generator=g,
                            device="cuda", dtype=torch.int32)

    # 1. prefill through kernel 8, warm once, then timed
    prefill = build_prefill(cfg)
    zero_counts()
    logits = prefill(params, {"tokens": prompts})
    if logits.shape != (PREFILL_B, PREFILL_S, cfg.vocab_size) or logits.dtype != torch.bfloat16:
        raise AssertionError(f"prefill logits {tuple(logits.shape)} {logits.dtype}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite prefill logits")
    del logits
    torch.cuda.reset_peak_memory_stats()   # the timed calls' peak, not the checks'
    times = []
    for _ in range(PREFILL_REPS):
        logits = None
        torch.cuda.synchronize()
        t = time.perf_counter()
        logits = prefill(params, {"tokens": prompts})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    tail = logits[:, -PREFILL_TAIL:].float()   # the last timed call's, compared below
    del logits
    counts = read_counts()
    calls = 1 + PREFILL_REPS
    want = dict(dict.fromkeys(KERNELS, 0), flash_attention=cfg.n_layers * calls)
    if counts != want:
        raise AssertionError(f"prefill launches {counts}, expected {want}")
    tc = _module("flash_attention").launches_tc
    if tc != cfg.n_layers * calls:
        raise AssertionError(f"{tc} of the prefill's {cfg.n_layers * calls} kernel-8 launches "
                             "went to the bf16 tensor-core kernel")
    launches = dict(counts, **{"flash_attention[tensor_core]": tc})
    ms = 1e3 * statistics.median(times)
    print(f"  prefill {PREFILL_B} x {PREFILL_S} tokens: {ms:.2f} ms (median of "
          f"{PREFILL_REPS}; {[round(1e3 * t, 2) for t in times]}), "
          f"{PREFILL_B * PREFILL_S / ms * 1e3:.0f} prompt tokens/s, peak memory "
          f"{peak / 2**30:.2f} GiB; kernel 8 launches {counts['flash_attention']} in "
          f"{calls} calls ({cfg.n_layers} a call), {tc} of them on the bf16 tensor-core "
          "kernel")

    # 2. the same prompts on the reference's second route (flash=False)
    zero_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits = build_prefill(cfg, flash=False)(params, {"tokens": prompts})
    torch.cuda.synchronize()
    chunked_ms = 1e3 * (time.perf_counter() - t)
    ref_tail = logits[:, -PREFILL_TAIL:].float()
    del logits
    if read_counts() != dict.fromkeys(KERNELS, 0):
        raise AssertionError(f"flash=False launched {read_counts()}")
    print(f"  prefill with flash=False (chunked online softmax): {chunked_ms:.2f} ms; top-1 "
          f"at each prompt's last position {tail[:, -1].argmax(-1).tolist()} vs "
          f"{ref_tail[:, -1].argmax(-1).tolist()}")
    check_logits(torch, f"prefill flash vs flash=False, each prompt's last {PREFILL_TAIL} "
                 "positions", tail, ref_tail)
    del tail, ref_tail

    # 3. decode against a 32k cache: a 64-token prompt, then 32 greedy tokens
    cache = M.init_cache(cfg, DECODE_B, DECODE_32K.seq_len)
    cache_gib = sum(t.numel() * t.element_size() for t in cache["layers"].values()) / 2**30
    prompt = torch.randint(0, cfg.vocab_size, (DECODE_B, PROMPT), generator=g, device="cuda",
                           dtype=torch.int32)
    step = build_decode_step(cfg)
    zero_counts()
    stepped = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(PROMPT):
        lg, cache = step(params, cache, prompt[:, i:i + 1])
        stepped.append(lg)
    torch.cuda.synchronize()
    prompt_ms = 1e3 * (time.perf_counter() - t) / PROMPT
    gen = []
    t = time.perf_counter()
    for _ in range(NEW_TOKENS):
        gen.append(lg[:, -1].argmax(-1, keepdim=True).to(torch.int32))
        lg, cache = step(params, cache, gen[-1])
        stepped.append(lg)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t) / NEW_TOKENS
    if read_counts() != dict.fromkeys(KERNELS, 0):
        raise AssertionError(f"decode launched {read_counts()}")
    if cache["idx"] != PROMPT + NEW_TOKENS:
        raise AssertionError(f"cache idx {cache['idx']}")
    print(f"  decode batch {DECODE_B}, cache of {DECODE_32K.seq_len} positions "
          f"({cache_gib:.2f} GiB bf16): {prompt_ms:.3f} ms a step through the prompt, "
          f"{step_ms:.3f} ms a step over {NEW_TOKENS} greedy tokens "
          f"({DECODE_B / step_ms * 1e3:.1f} tokens/s); kernel 8 launches 0")
    # two parts of a step, timed alone on its shapes: one layer's dense
    # attention over the whole cache (the reference's mask over the
    # capacity), and the casts of every f32 weight to bf16
    kc, vc = cache["layers"]["k"][0], cache["layers"]["v"][0]
    qd = torch.randn((DECODE_B, cfg.n_heads, 1, cfg.head_dim_), generator=g,
                     device="cuda").to(torch.bfloat16)
    live = (torch.arange(kc.shape[2], device="cuda") < cache["idx"])[None, None, None, :]
    scale = 1.0 / cfg.head_dim_ ** 0.5
    attn_ms = time_cuda(torch, lambda: L._sdpa(qd, kc, vc, live, scale), 3, 20)
    cast_ms = time_cuda(torch, lambda: [p.to(torch.bfloat16) for p in params.parameters()],
                        2, 5)
    print(f"  of a decode step: attention over the cache {attn_ms:.3f} ms a layer "
          f"({cfg.n_layers * attn_ms:.2f} ms for {cfg.n_layers}), the weights' casts "
          f"{cast_ms:.3f} ms")

    # 4. the stepped logits against one prefill of the same 96 tokens
    seq = torch.cat([prompt] + gen, dim=1)
    zero_counts()
    pf = prefill(params, {"tokens": seq}).float()
    if read_counts() != dict.fromkeys(KERNELS, 0):
        raise AssertionError(f"a prefill of {seq.shape[1]} tokens launched {read_counts()}")
    st = torch.cat(stepped, dim=1).float()
    if not bool(torch.isfinite(st).all()):
        raise AssertionError("non-finite decode logits")
    check_logits(torch, f"decode vs one prefill of the same {seq.shape[1]} tokens", st, pf)
    del cache, params
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.core.topology import make_topology
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.dfl.engine import DFLConfig, run_experiment
    from repro_torch.kernels import common

    print(gpu_line())

    # ---- phase 1: build -----------------------------------------------------
    t0 = time.perf_counter()
    libs = common.build(*dict.fromkeys(ROOT / src for _, _, src, _ in KERNELS.values()))
    print(f"[1] built {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for so in libs:
        entry = ""
        for line in so.with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]     # the mangled kernel and its template
            if "registers" in line or "spill" in line:
                print(f"    {so.name.rsplit('_', 1)[0]} {entry} ptxas: {line.strip()}")
    print_cluster_sizes()
    print_stats_plans()

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
    errs["pairwise_gram"] = [compare_gram(torch, K, D, 9) for K, D in (
        (CFL_K, CFL_D), (BIG_K, BIG_D), (7, 37), (32, 37))]
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
    for N, K, d, seed in ((20, 8, 44426, 22), (40, 16, 44426, 23), (40, 20, 44426, 29),
                          (48, 32, 20011, 24)):
        idx, valid = irregular_slate(N, K, seed)
        slates.append((f"irregular N={N} K={K} d={d} (degree 0)", N, K, d, idx, valid,
                       seed))
    errs["robust_stats_indexed"], errs["weighted_agg_indexed"] = [], []
    for label, N, K, d, idx, valid, seed in slates:
        errs["wfagg_round_indexed"].append(compare_gram_round(
            torch, f"Gram round {label}", N, K, d, idx, valid, seed, dup=(0, 4)))
        combos = (((False, False), (True, False), (False, True), (True, True))
                  if K in (8, 20) else ((False, False), (True, True)))
        errs["robust_stats_indexed"] += [compare_indexed_stats(
            torch, f"robust_stats_indexed {label}", N, K, d, idx, valid, seed, (0, 4),
            with_prev, need_gram) for with_prev, need_gram in combos]
        errs["weighted_agg_indexed"].append(compare_weighted_agg_indexed(
            torch, f"weighted_agg_indexed {label}", N, K, d, idx, valid, seed))
    paper_timed = time_dfl_kernels(torch, 20, 8, 44426, seed=25)
    dfl_timed = time_dfl_kernels(torch, 64, 16, 1 << 20, seed=26)
    timed["wfagg_round_indexed"]["gram_variant"] = dfl_timed.pop("wfagg_round_indexed_gram")
    timed.update(dfl_timed)
    time_gram_epilogue(torch, 64, 32, 8192, seed=28)
    time_dfl_backends(torch, 64, 16, 1 << 20, seed=27)

    print("[2] the prev_idx variants of the round and statistics kernels on stacked "
          "chaos matrices (apply_transport)")
    r, flat, tout = paper_chaos_stack(torch, 44426)
    for name, e in compare_prev_idx(torch, f"paper N=20 K=8 d=44426 churn+chaos round {r}",
                                    flat, tout, seed=41).items():
        errs[name] = e
    for N, K, d, seed in ((40, 16, 44426, 42), (48, 32, 20011, 43)):
        idx, valid = irregular_slate(N, K, seed)
        flat, tout = chaos_stack(torch, N, K, d, idx, valid, seed)
        for name, e in compare_prev_idx(torch, f"irregular N={N} K={K} d={d} (degree 0)",
                                        flat, tout, seed).items():
            errs[name] += e
    check_overflow_row(torch)
    check_kernel_order(torch, [sl for sl in slates if sl[2] != 8 or sl[5] is None])
    timed.update(time_prev_idx_kernels(torch, 64, 16, 1 << 20, seed=44))
    paper_timed.update(time_prev_idx_kernels(torch, 20, 8, 44426, seed=45))

    print("[2] kernel 5 (the gathered statistics) and the per-edge prev variants of the "
          "round and statistics kernels")
    errs["robust_stats_batch"], k5 = check_kernel5(torch)
    check_stats_kernel_order(torch)
    (main_shape, main_t), *rest = [(s_, t) for s_, t in k5.items() if s_[0] == 64] + [
        (s_, t) for s_, t in k5.items() if s_[0] != 64]
    shape_label = lambda s_: (f"N={s_[0]} K={s_[1]} d={s_[2]} prev={s_[3]} "  # noqa: E731
                              f"centers={s_[4]}")
    timed["robust_stats_batch"] = dict(main_t, shape=shape_label(main_shape),
                                       other_shapes={shape_label(s_): t for s_, t in rest})
    errs["wfagg_round_indexed[per_edge_prev]"] = []
    errs["robust_stats_indexed[per_edge_prev]"] = []
    for label, N, K, d, idx, valid, seed in slates:
        for name, e in compare_per_edge(torch, f"per-edge prev {label}", N, K, d, idx,
                                        valid, seed + 30, (0, 4)).items():
            errs[name] += e
    timed.update(time_per_edge_kernels(torch, 64, 16, 1 << 20, seed=57))
    paper_timed.update(time_per_edge_kernels(torch, 20, 8, 44426, seed=58))
    paper_timed["wfagg_round_indexed"] = dict(zip(
        ("ms", "plain_ms", "bound_ms", "bound_by"), paper))
    print_round_kernel_times(timed, paper_timed)
    for name in KERNELS:
        if name.startswith(("wfagg_round_indexed", "robust_stats_indexed")):
            timed[name]["paper_shape"] = paper_timed[name]

    print("[2] kernel 8, flash attention")
    errs["flash_attention"], timed["flash_attention"] = check_flash(torch)

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

    print("[3] Table I: run_experiment, MLP, paper topology (spaced), IPM-100, 4 rounds, "
          "every aggregator in DFL and CFL")
    table, table_launches = run_table1(torch, data)
    accs = {agg: table[(agg, False)]
            for agg in ("mean", "wfagg", "alt_wfagg", "multi_krum", "clustering")}
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

    accs = {agg: table[(agg, True)] for agg in ("mean", "wfagg", "alt_wfagg")}
    print(f"  CFL IPM-100 claim (MLP, 4 rounds): wfagg {accs['wfagg']:.4f}, "
          f"alt_wfagg {accs['alt_wfagg']:.4f}, mean {accs['mean']:.4f}")
    if not (accs["wfagg"] > accs["mean"] + 0.2 and accs["alt_wfagg"] > accs["mean"] + 0.2):
        raise AssertionError(f"CFL IPM-100 claim does not hold: {accs}")

    print(f"[3] dynamic topologies and chaos transport: run_dynamic_experiment, "
          f"LeNet-5, the same topology, IPM-100, {ROUNDS} rounds")
    dyn_launches = run_dynamic_paths(torch, topo, data)

    print(f"[3] the gathered wfagg_batch with per-edge WFAgg-T state: LeNet-5, the same "
          f"topology, IPM-100, {ROUNDS} rounds")
    gathered_launches = run_gathered_path(torch, topo, data)

    print(f"[3] serving {SERVE_ARCH} at full width: build_prefill (kernel 8 in every layer) "
          f"and build_decode_step")
    serve_launches = run_serve_path(torch)

    # each kernel's launches on the main paths that run it: the round kernel
    # on the DFL WFAgg and Alt-WFAgg runs, kernels 2 and 3 on the two
    # two-launch runs, the CFL kernels on the two CFL runs, the dynamic and
    # chaos runs (the prev_idx variants on the chaos runs only), Table I's
    # WFAgg and Alt-WFAgg runs, and the gathered path (kernel 5; the
    # per-edge variants on the indexed calls fed its state), and kernel 8 on the
    # full-width prefills
    launches = {name: dfl_launches[name] + cfl_launches[name] + dyn_launches[name]
                + table_launches[name] + gathered_launches[name] + serve_launches[name]
                for name in KERNELS}
    timed["flash_attention"]["launches_tc"] = serve_launches["flash_attention[tensor_core]"]
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
