"""The noise attack's transient memory on one model rank's buffers.

One rank of StableLM-3B split over M = 4 (``model_rank`` 0), its K = 8
candidates emulated: the flat layout's (K, P_s) and (K, P_r) buffers, or
the stacked layout's candidate tree of views of them, on one card.  The
noise attack runs on them in place (``apply_distributed_attack`` with the
rank's ``FlatShards`` places; ``apply_stacked_attack`` with its
``ModelShards``), and the card's peak allocation above the buffers is the
attack's transient.  ``--src`` picks the tree whose ``repro_torch`` runs,
so two commits compare in one call on one card:

    git archive <commit> src | tar -x -C .archive/parent
    python3 scripts/noise_peak.py --src .archive/parent/src --tag parent
    python3 scripts/noise_peak.py --src src --tag change

Prints the card's name and power limit, then one JSON line per layout:
the transient in GiB and the attack's ms (host clock between
``torch.cuda.synchronize()`` calls).  Needs a CUDA card.
"""
import argparse
import json
import pathlib
import subprocess
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="src", help="the tree whose repro_torch to import")
    ap.add_argument("--tag", default="change")
    ap.add_argument("--arch", default="stablelm-3b")
    ap.add_argument("--model", type=int, default=4, help="M, the model axis")
    ap.add_argument("--candidates", type=int, default=8, help="K, emulated")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("noise_peak: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch.configs.registry import get_config
    from repro_torch.core import flatten as F
    from repro_torch.core.topology import spaced_malicious
    from repro_torch.distributed import robust_allreduce as ra
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import model as M

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    cfg = get_config(args.arch)
    K = args.candidates
    # the rank's blocks, shapes only, then its buffers on the card
    model = M.init_params(cfg, None, "meta")
    M.cut_model_(cfg, model, Mesh(shape={"data": 1, "model": args.model}), rank=0)
    places, P = F.coord_places(model)
    sizes = [sum(p.numel() for _, ps in g for p in ps) for g in F.split_groups(model)]
    dtype = getattr(torch, cfg.param_dtype)
    mal = torch.as_tensor(spaced_malicious(K, 2), device="cuda")
    for layout in ("flat", "stacked"):
        bufs = tuple(torch.zeros((K, n), dtype=dtype, device="cuda") for n in sizes)
        gen = torch.Generator(device="cuda").manual_seed(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        if layout == "flat":
            shards = ra.FlatShards(group=None, counted=(True, True),
                                   places=tuple(tuple(p) for p in places), size=P)
            ra.apply_distributed_attack(bufs, ra.Emulated(K), mal, "noise", gen,
                                        chunk_size=1 << 22, in_place=True, model_shards=shards)
        else:
            axis = model.tp
            cuts = tuple(None if c is None else c[0] for c in F.split_cuts(model))
            ra.apply_stacked_attack(F.unravel_rows_split(bufs, model), mal, "noise", gen,
                                    in_place=True, model_shards=ra.ModelShards(axis, cuts))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        print(json.dumps({"tag": args.tag, "arch": args.arch, "layout": layout, "M": args.model,
                          "K": K, "P": P, "P_rank": sizes, "transient_gib": round(peak, 4),
                          "ms": round(ms, 1), "card": card}))
        del bufs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
