"""Peak card memory of one robust-DP training step of an MoE model with and
without remat (``cfg.remat``: every block recomputed in the backward).

DeepSeek-V2-Lite at 2 of 27 layers (1 dense prefix + 1 MoE block,
1.03e9 parameters), K = 6 candidates of one row of 1025 tokens, IPM-100 on
spaced_malicious(6, 2), WFAgg on the ``fused`` route, AdamW: the one-card
MoE training step of ``chip_smoke.py --only moe``.  Each variant runs in a
process of its own (the allocator's expandable segments on, as there): a
warm step, then ``torch.cuda.max_memory_allocated`` over each phase of a
second step (the candidate gradients, the attack, the all-reduce, the
optimizer) and its largest, the step's peak.
Needs a CUDA card and ``nvcc``; run from the repository root:

    python3 scripts/remat_peak.py

Prints the card (``nvidia-smi``'s name and power limit) and one JSON line
per variant, then one with both.
"""
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH, LAYERS, K, SEQ, N_MAL = "deepseek-v2-lite-16b", 2, 6, 1025, 2


def one(remat: bool) -> dict:
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses

    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.core.wfagg import WFAggConfig
    from repro_torch.data.synthetic import TokenStream
    from repro_torch.distributed.robust_allreduce import RobustAggConfig
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import trainer as tr

    cfg = dataclasses.replace(get_config(ARCH), n_layers=LAYERS, remat=remat)
    tc = tr.TrainConfig(agg=RobustAggConfig(method="wfagg", layout="stacked", backend="fused",
                                            wfagg=WFAggConfig(f=2, transient=3, window=3)),
                        attack="ipm_100", n_malicious=N_MAL, lr=1e-3, warmup=0)
    mesh = make_test_mesh(data=K)
    state = tr.init_train_state(cfg, tc, torch.Generator(device="cuda").manual_seed(0), mesh)
    phases = {}

    def observe(phase, **_):
        # each phase's own peak: the allocator's high-water mark since the
        # last phase ended
        torch.cuda.synchronize()
        phases[phase] = round(torch.cuda.max_memory_allocated() / 2 ** 30, 2)
        torch.cuda.reset_peak_memory_stats()

    step = tr.build_train_step(cfg, tc, mesh, observe=observe)
    stream = TokenStream(cfg.vocab_size, SEQ, K)
    state, _ = step(state, stream.batch(0, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    state, m = step(state, stream.batch(1, device="cuda"))
    torch.cuda.synchronize()
    return {"remat": remat, "params": sum(p.numel() for p in state.params.parameters()),
            "peak_gib": max(phases.values()), "phase_peak_gib": phases,
            "step_ms": round(1e3 * (time.perf_counter() - t), 1), "loss": float(m["loss"])}


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--remat":
        print(json.dumps(one(sys.argv[2] == "1")))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import common

    common.build(*dict.fromkeys(ROOT / src for _, _, src, _ in chip_smoke.KERNELS.values()))
    out = []
    for flag in ("0", "1"):
        res = subprocess.run([sys.executable, __file__, "--remat", flag], capture_output=True,
                             text=True)
        if res.returncode:
            print(res.stderr[-4000:], file=sys.stderr)
            return 1
        out.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(out[-1]))
    print(json.dumps({"remat_peak": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
