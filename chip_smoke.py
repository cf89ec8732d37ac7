#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs on
an NVIDIA H100.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``nvidia-smi``; exits non-zero (and
prints no result) without them or outside a checkout of the repository.
Phases, each of which fails the run:

  1. the card's name and power limit; build every kernel of the port from
     the sources in the checkout (timed);
  2. hold each kernel against its plain PyTorch version on the card, at
     the paper's round shape (N=20, K=8, d=44,426) and on irregular slates
     with a degree-0 row at K=16 and K=32 (masks bit-equal, ``out`` within
     3e-5); time the kernel, its plain version and its bound at N=64,
     K=16, d=2^20 with CUDA events;
  3. the main path: ``run_experiment`` at the paper's configuration
     (LeNet-5, 20-node 8-regular ring, 2 Byzantine nodes placed close,
     IPM-100, WFAgg on the single-launch backend, 6 rounds) with every
     kernel's launch count set to 0 just before and read just after, the
     mean baseline beside it; then the round checked against the
     reference backend on the card, round by round, and the paper's
     IPM-100 claim (WFAgg > 0.9 and > mean + 0.2) on the MLP config.

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
KERNEL_SOURCE = "src/repro_torch/kernels/robust_stats/csrc/wfagg_round.cu"
REPLACES = "src/repro/kernels/robust_stats/kernel.py:511"


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
# phase 3: the main path
# ---------------------------------------------------------------------------

def check_against_reference(torch, cfg, topo, data, rounds):
    """Replay the fused run round by round: from each of its states, one
    fused and one reference round (deterministic cuDNN, so local training
    is identical) must give bit-equal verdicts and models within 3e-5."""
    import dataclasses

    from repro_torch.dfl import engine
    from repro_torch.models.lenet import ravel

    ref_cfg = dataclasses.replace(cfg, wfagg_backend="reference")
    fused = engine.build_round_fn(cfg, topo, data, telemetry=True)
    ref = engine.build_round_fn(ref_cfg, topo, data, telemetry=True)
    state = engine.init_dfl_state(cfg, topo)
    benign = torch.as_tensor(~topo.malicious, device="cuda")
    torch.backends.cudnn.deterministic = True
    try:
        t_fired, nonfinite = 0, []
        for r in range(rounds):
            nxt, rec = fused(state)
            alt, rec_ref = ref(state)
            if not torch.equal(rec.verdict, rec_ref.verdict):
                raise AssertionError(f"round {r + 1}: verdicts differ from the "
                                     "reference backend")
            flat = ravel(nxt.node_params)
            # an attacker's own model may go non-finite (the reference's
            # attack math carries it); every benign model must not
            finite = torch.isfinite(flat).all(1)
            if not finite[benign].all():
                raise AssertionError(f"round {r + 1}: a benign model is not finite")
            nonfinite.append(torch.nonzero(~finite).flatten().tolist())
            torch.testing.assert_close(flat, ravel(alt.node_params), rtol=OUT_TOL,
                                       atol=OUT_TOL, equal_nan=True)
            t_fired += int(((rec.verdict >> 2) & 1).sum())
            state = nxt
    finally:
        torch.backends.cudnn.deterministic = False
    print(f"  fused == reference backend on the card, {rounds} rounds: verdicts "
          f"bit-equal, models within {OUT_TOL}; WFAgg-T accepted {t_fired} edges; "
          f"non-finite (attacker) rows per round {nonfinite}")
    if t_fired == 0:
        raise AssertionError("the in-kernel WFAgg-T band test never fired")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import numpy as np

    from repro_torch.core.topology import make_topology, paper_topology
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.dfl.engine import DFLConfig, run_experiment
    from repro_torch.kernels.robust_stats import kernel as rk

    print(gpu_line())

    # ---- phase 1: build -----------------------------------------------------
    t0 = time.perf_counter()
    so = rk.build()
    print(f"[1] built {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"    ptxas: {line.strip()}")

    # ---- phase 2: kernel vs plain -------------------------------------------
    print("[2] kernel vs plain version on the card")
    topo = make_topology(20, 8, 2, "ring", placement="close")
    errs = [compare_kernel(torch, "paper N=20 K=8 d=44426", 20, 8, 44426,
                           topo.neighbor_indices, None, seed=1, dup=(0, 4))]
    for N, K, d, seed in ((40, 16, 44426, 2), (48, 32, 20011, 3)):
        idx, valid = irregular_slate(N, K, seed)
        errs.append(compare_kernel(torch, f"irregular N={N} K={K} d={d} (degree 0)",
                                   N, K, d, idx, valid, seed=seed))
    paper = time_round(torch, 20, 8, 44426, seed=5)
    print(f"  paper shape N=20 K=8 d=44426: kernel {paper[0]:.4f} ms, plain "
          f"{paper[1]:.4f} ms, bound {paper[2]:.5f} ms ({paper[3]})")
    ms, plain_ms, bound_ms, bound_by = time_round(torch, 64, 16, 1 << 20, seed=6)
    print(f"  N=64 K=16 d=2^20: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}); no single PyTorch call computes "
          "this function, so there is no library time")

    # ---- phase 3: the main path ---------------------------------------------
    print("[3] main path: run_experiment, LeNet-5, paper topology, IPM-100, 6 rounds")
    data = SyntheticImages()
    cfg = DFLConfig(aggregator="wfagg", attack="ipm_100", model="lenet",
                    wfagg_backend="fused")
    rounds = 6
    rk.launches = 0
    out = run_experiment(cfg, topo, data, rounds=rounds)
    launches = rk.launches
    base = run_experiment(DFLConfig(aggregator="mean", attack="ipm_100", model="lenet"),
                          topo, data, rounds=rounds)
    for name, o in (("wfagg", out), ("mean", base)):
        s = o["series"]
        print(f"  {name:5s} benign acc per round "
              f"{[round(a, 4) for a in s['acc_benign_mean']]}, round ms "
              f"{[round(1e3 * t, 2) for t in s['round_seconds']]}")
    if launches != rounds:
        raise AssertionError(f"{launches} kernel launches in {rounds} WFAgg rounds")
    print(f"  wfagg_round_indexed launches on the main path: {launches} "
          f"(one per round)")
    if not all(np.isfinite(e["acc_all"]).all() for e in out["trace"]):
        raise AssertionError("non-finite accuracy on the main path")
    check_against_reference(torch, cfg, topo, data, rounds)

    accs = {}
    for agg in ("mean", "wfagg"):
        o = run_experiment(DFLConfig(aggregator=agg, attack="ipm_100", model="mlp"),
                           paper_topology(), data, rounds=4, eval_every=4)
        accs[agg] = o["final"]["acc_benign_mean"]
    print(f"  IPM-100 claim (MLP, 4 rounds): wfagg {accs['wfagg']:.4f}, "
          f"mean {accs['mean']:.4f}")
    if not (accs["wfagg"] > 0.9 and accs["wfagg"] > accs["mean"] + 0.2):
        raise AssertionError(f"IPM-100 claim does not hold: {accs}")

    print(json.dumps({"kernels": [{
        "name": "wfagg_round_indexed", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max(errs),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
