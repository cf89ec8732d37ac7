#!/usr/bin/env python3
"""Time kernels 1 and 2 of the port (the single-launch gossip round,
``wfagg_round.cu``, and the indexed statistics, ``robust_stats_indexed.cu``)
in every variant at N=64, K=16, d=2^20 and at the paper's N=20, K=8,
d=44,426, kernels 4 and 5 (``robust_stats.cu``: one matrix, and the
gathered tensor) at their timed shapes, and kernels 3 and 7 (the combines,
``weighted_agg_indexed.cu`` and ``weighted_agg.cu``) at theirs, of one
source tree, with ``chip_smoke.py``'s timing functions (CUDA events,
median of 25; kernels 3, 4, 5 and 7 also by device time per call,
``torch.profiler``); prints the card and one JSON line.

    python3 scripts/compare_round_kernels.py [--src SRC] [--tag TAG]
                                             [--only round|stats|combine]

SRC is the ``src`` directory whose ``repro_torch`` is timed (default: this
checkout's); its kernels build into its own ``kernels/_build``.  ``--only
round`` times kernels 1 and 2 alone, ``--only stats`` kernels 4 and 5
alone: kernel 4 with prev and no centers (the CFL server's call) at K=20
d=44,426 and K=32 D=2^22; kernel 5 with per-edge prev and no centers at
N=20 K=8 d=44,426 and N=64 K=16 d=2^20, and without prev with the
centers at N=64 K=16 d=2^20; and the gathered ``wfagg_batch`` (WFAgg) at
N=64 K=16 d=2^20, the layer that calls kernel 5, and the CFL round's
steady times, the end-to-end metric above kernel 4.  ``--only combine``
times kernels 3 and 7 alone: the ``*_cuda`` wrapper at N=64 K=16 d=2^20
(kernel 3) and K=32 D=2^22 (kernel 7), and at the paper's shapes (N=20
K=8 / K=20, d=44,426) where the tree takes rows of that width as they
are, the ``ops`` wrapper the main path calls at both (where a tree that
pads rows to a multiple of 4 copies them first), beside the
one PyTorch call of each (the gather and ``torch.baddbmm``;
``torch.addmv``), and the indexed ``wfagg_batch`` (WFAgg) on
``fused_two_launch`` at N=64 K=16 d=2^20, the layer that calls kernel 3.
To compare two commits on one card, unpack
the other into a git-ignored directory (``git archive <commit> src | tar
-x -C .archive/parent``) and run both in one call, in turns: parent,
change, change, parent.  Needs one CUDA card.
"""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def round_kernels(torch, cs) -> dict:
    out = {}
    for shape, (N, K, d) in (("big", (64, 16, 1 << 20)), ("paper", (20, 8, 44426))):
        ms, plain_ms, bound_ms, bound_by = cs.time_round(torch, N, K, d, seed=6)
        t = {"wfagg_round_indexed": dict(ms=ms, bound_ms=bound_ms)}
        dfl = cs.time_dfl_kernels(torch, N, K, d, seed=26)
        t["wfagg_round_indexed.gram_variant"] = dfl["wfagg_round_indexed_gram"]
        for name in ("robust_stats_indexed", "robust_stats_indexed_no_gram"):
            t[name] = dfl[name]
        t.update(cs.time_prev_idx_kernels(torch, N, K, d, seed=44))
        t.update(cs.time_per_edge_kernels(torch, N, K, d, seed=57))
        out[shape] = {k: round(v["ms"], 4) for k, v in t.items()}
        torch.cuda.empty_cache()
    return out


def device_ms(torch, fn, calls=20) -> float:
    """Milliseconds of device time per call of ``fn``: every CUDA kernel it
    launches, summed by ``torch.profiler`` over ``calls`` calls after a
    warm-up; the host's launch overhead, which the event timers include at
    small shapes, is left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0) or getattr(e, "cuda_time_total", 0)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    return total / calls / 1e3


def stats_kernels(torch, cs) -> dict:
    """Kernels 4 and 5 at their timed shapes: ``chip_smoke``'s event time of
    the wrapper (``ms``) and the device time per call (``device_ms``)."""
    from repro_torch.kernels.robust_stats import kernel as rk

    out = {}
    for K, D, seed in ((cs.CFL_K, cs.CFL_D, 11), (cs.BIG_K, cs.BIG_D, 12)):
        u, prev, _ = cs.cfl_candidates(torch, K, D, seed)
        t = cs.time_robust_stats(torch, u, prev)
        dev = device_ms(torch, lambda: rk.robust_stats_cuda(u, prev, 0.1, False))
        out[f"robust_stats K={K} D={D} prev"] = dict(ms=round(t["ms"], 4),
                                                     device_ms=round(dev, 4))
        del u, prev
        torch.cuda.empty_cache()
    for N, K, d, with_prev, centers, seed in ((20, 8, 44426, True, False, 51),
                                              (64, 16, 1 << 20, True, False, 52),
                                              (64, 16, 1 << 20, False, True, 53)):
        u, prev, _ = cs.gathered_candidates(torch, N, K, d, seed)
        p = prev if with_prev else None
        t = cs.time_robust_stats_batch(torch, u, p, centers)
        # the unpadded rows the main path hands the kernel
        dev = device_ms(torch, lambda: rk.robust_stats_batch_cuda(u, p, 0.1, centers))
        label = "per-edge prev" if with_prev else "no prev, centers"
        out[f"robust_stats_batch N={N} K={K} d={d} {label}"] = dict(
            ms=round(t["ms"], 4), device_ms=round(dev, 4))
        del u, prev, p
        torch.cuda.empty_cache()
    out["wfagg_batch gathered N=64 K=16 d=1048576"] = dict(ms=round(gathered_round(torch, cs),
                                                                  4))
    out["CFL round, WFAgg, LeNet-5, rounds 2-6"] = dict(ms=cfl_round_ms())
    return out


def combine_kernels(torch, cs) -> dict:
    """Kernels 3 and 7 and what they are held against: event ms (median of 25)
    and device ms per call of each call, at the timed and the paper's
    shapes."""
    from repro_torch.core.trust import combine_coefficients
    from repro_torch.kernels.weighted_agg import kernel as wk
    from repro_torch.kernels.weighted_agg import ops as wops

    def both(fn) -> dict:
        return dict(ms=round(cs.time_cuda(torch, fn, 3, 25), 4),
                    device_ms=round(device_ms(torch, fn), 4))

    def takes(fn) -> bool:
        """The tree's ``*_cuda`` wrapper takes these rows as they are (a tree
        that needs D % 4 == 0 raises)."""
        try:
            fn()
        except ValueError:
            return False
        return True

    out = {}
    for N, K, d, seed in ((64, 16, 1 << 20, 26), (20, 8, 44426, 25)):
        models, local, idx, w, wvec, lcoef = cs.combine_indexed_inputs(torch, N, K, d, seed)
        lc = float(lcoef[0])
        shape = f"N={N} K={K} d={d}"
        cuda = lambda: wk.weighted_agg_indexed_cuda(wvec, lcoef, local, models, idx)  # noqa: E731
        if takes(cuda):
            out[f"weighted_agg_indexed_cuda {shape}"] = both(cuda)
        out[f"ops.weighted_agg_indexed {shape}"] = both(
            lambda: wops.weighted_agg_indexed(local, models, idx, w))
        out[f"models[idx] + baddbmm {shape}"] = both(
            lambda: torch.baddbmm(local[:, None], wvec[:, None], models[idx.long()], beta=lc))
        del models, local
        torch.cuda.empty_cache()
    for K, D, seed in ((cs.BIG_K, cs.BIG_D, 12), (cs.CFL_K, cs.CFL_D, 11)):
        u, _, dup = cs.cfl_candidates(torch, K, D, seed)
        w = torch.where(torch.arange(K, device="cuda") % 3 == 0, 0.6, 0.8)
        w[0] = w[dup] = 0.0
        wvec, lcoef = combine_coefficients(w, 0.8)
        lcoef = lcoef.reshape(1)
        local = u[1:].mean(0)
        lc = float(lcoef)
        shape = f"K={K} D={D}"
        cuda = lambda: wk.weighted_agg_cuda(wvec, lcoef, local, u)  # noqa: E731
        if takes(cuda):
            out[f"weighted_agg_cuda {shape}"] = both(cuda)
        out[f"ops.weighted_agg {shape}"] = both(lambda: wops.weighted_agg(local, u, w))
        out[f"addmv {shape}"] = both(lambda: torch.addmv(local, u.t(), wvec, beta=lc))
        del u, local
        torch.cuda.empty_cache()
    ms = cs.time_dfl_backends(torch, 64, 16, 1 << 20, seed=27, aggregators=("wfagg",))
    out["wfagg_batch WFAgg N=64 K=16 d=1048576"] = ms["wfagg"]
    return out


def cfl_round_ms() -> list:
    """The end-to-end metric above kernel 4: the steady round times (ms,
    rounds 2 to 6, host clock between synchronisations) of
    ``run_experiment`` on the CFL main path of ``chip_smoke.py`` (WFAgg,
    LeNet-5, the paper's topology, IPM-100): one kernel-4 launch a round."""
    from repro_torch.core.topology import make_topology
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.dfl.engine import DFLConfig, run_experiment

    cfg = DFLConfig(aggregator="wfagg", attack="ipm_100", model="lenet", centralized=True)
    out = run_experiment(cfg, make_topology(20, 8, 2, "ring", placement="close"),
                         SyntheticImages(), rounds=6)
    return [round(1e3 * t, 2) for t in out["series"]["round_seconds"][1:]]


def gathered_round(torch, cs) -> float:
    """The layer above kernel 5: the gathered ``wfagg_batch`` (WFAgg on
    ``fused``: one kernel-5 launch, the host scoring stage, the batched
    combine) with per-edge WFAgg-T state past its transient, at N=64,
    K=16, d=2^20; event ms, median of 10."""
    from repro_torch.core import wfagg as wf

    N, K, d = 64, 16, 1 << 20
    u, prev, _ = cs.gathered_candidates(torch, N, K, d, seed=54)
    g = torch.Generator(device="cuda").manual_seed(55)
    hist = lambda: 1 + 0.1 * torch.rand((N, 3, K), generator=g, device="cuda")  # noqa: E731
    i32 = dict(dtype=torch.int32, device="cuda")
    state = wf.TemporalState(prev=prev, hist_s=hist(), hist_b=hist(),
                             count=torch.full((N,), 3, **i32), t=torch.full((N,), 5, **i32))
    local = u[:, 1].contiguous()
    cfg = wf.WFAggConfig(backend="fused")
    ms = cs.time_cuda(torch, lambda: wf.wfagg_batch(local, u, state, cfg), 2, 10)
    del u, prev, state, local
    torch.cuda.empty_cache()
    return ms


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="")
    ap.add_argument("--only", choices=("round", "stats", "combine"), default=None)
    args = ap.parse_args()
    # the timed tree's package first: chip_smoke's helpers then use it
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("compare_round_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    import repro_torch.kernels.robust_stats.kernel  # noqa: F401  (from --src)

    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs

    out = {}
    if args.only in (None, "round"):
        out.update(round_kernels(torch, cs))
    if args.only in (None, "stats"):
        out["stats"] = stats_kernels(torch, cs)
    if args.only in (None, "combine"):
        out["combine"] = combine_kernels(torch, cs)
    print(cs.gpu_line())
    print(json.dumps({"tag": args.tag, "src": args.src, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
