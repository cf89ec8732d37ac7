#!/usr/bin/env python3
"""Time kernels 1 and 2 of the port (the single-launch gossip round,
``wfagg_round.cu``, and the indexed statistics, ``robust_stats_indexed.cu``)
of one source tree, in every variant, at N=64, K=16, d=2^20 and at the
paper's N=20, K=8, d=44,426, with ``chip_smoke.py``'s timing functions
(CUDA events, median of 25); prints the card and one JSON line.

    python3 scripts/compare_round_kernels.py [--src SRC] [--tag TAG]

SRC is the ``src`` directory whose ``repro_torch`` is timed (default: this
checkout's); its kernels build into its own ``kernels/_build``.  To compare
two commits on one card, unpack the other into a git-ignored directory
(``git archive <commit> src | tar -x -C .archive/parent``) and run both in
one call, in turns: parent, change, change, parent.  Needs one CUDA card.
"""
import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="")
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
    print(cs.gpu_line())
    print(json.dumps({"tag": args.tag, "src": args.src, "ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
