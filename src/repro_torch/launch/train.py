"""Training launcher (port of ``repro.launch.train``).

Selects an architecture config (--arch), builds the candidate mesh, the
train state and the robust-DP (or gspmd) train step, feeds the synthetic
token pipeline, and runs with periodic logging and checkpointing:

    python -m repro_torch.launch.train --candidates 8 --agg-backend fused

``--candidates`` is the number of candidate workers K on the mesh's
``data`` axis (the reference's forced host-device count; times 2 pods
with ``--multi-pod``), and ``--agg-backend`` picks the stacked
all-reduce's backend (the reference's ``RobustAggConfig.backend``).  The
flat layout runs over the default ``torch.distributed`` group when one of
K ranks is initialised (one rank per candidate), else emulates the K
candidates in this process.  ``--model-parallel M`` splits a dense model
over the M ranks of the initialised default group, one tensor-parallel
shard each (every rank runs all K candidates on its shard), e.g. on M
cards:

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --model-parallel 2 \
        --candidates 8 --agg-backend fused

(each rank takes the card ``LOCAL_RANK`` names and joins an ``nccl``
group; on the CPU, ``gloo``).  Without such a group it raises.  Under
``torchrun`` with W ranks and ``--model-parallel M`` < W the data axis is
W / M processes (the reference's ``make_test_mesh(data=n_dev // model,
model=model)``): a grid of W / M candidates x M model shards
(``launch.mesh.make_grid``), each rank computing one candidate's gradient;
``--candidates`` (times 2 with ``--multi-pod``) must then equal W / M:

    torchrun --nproc-per-node 8 -m repro_torch.launch.train --model-parallel 2 \
        --candidates 4 --agg-backend fused

(the flat layout at M = 1 runs over the W ranks as one data group).
``--layout flat --model-parallel M`` runs the flat all-reduce on each
rank's model block: over the data group on a grid, over the K candidates
in the process on M ranks alone; the statistics' partial sums meet over
the model group:

    torchrun --nproc-per-node 8 -m repro_torch.launch.train --model-parallel 2 \
        --candidates 4 --layout flat --chunk-size 4194304

Arctic's own plan, bfloat16 parameters and Adafactor on the flat layout,
at one of its 35 layers over 4 cards (each rank emulating the K
candidates on its model block):

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch arctic-480b \
        --n-layers 1 --layout flat --model-parallel 4 --candidates 4

``--param-dtype`` and ``--optimizer`` override the config's (a
``--reduced`` config is float32 with SGD).  ``--production-mesh`` builds the reference's 16 x 16 (2 x 16 x 16) grid
from 256 (512) ranks.  Rank 0 prints and writes the checkpoints, gathered
to the whole model's format.  It runs on the card; ``main(argv,
device="cpu")`` runs it on the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_config
from repro_torch.core.wfagg import WFAggConfig
from repro_torch.data.synthetic import TokenStream
from repro_torch.distributed.robust_allreduce import RobustAggConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import make_grid, make_production_mesh, make_test_mesh
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import trainer as tr


def build_everything(args):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.d_model:
        cfg = dataclasses.replace(
            cfg, d_model=args.d_model, head_dim=args.d_model // cfg.n_heads,
            d_ff=args.d_ff or 4 * args.d_model)
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    if args.vocab:
        cfg = dataclasses.replace(cfg, vocab_size=args.vocab)
    if args.param_dtype:
        cfg = dataclasses.replace(cfg, param_dtype=args.param_dtype)
    if args.optimizer:
        cfg = dataclasses.replace(cfg, optimizer=args.optimizer)

    world = dist.get_world_size() if dist.is_initialized() else 1
    pods = 2 if args.multi_pod else 1
    if args.production_mesh:
        mesh = make_production_mesh(multi_pod=args.multi_pod)
    elif world > args.model_parallel:
        # the data axis as processes: W / M candidates, one rank each
        if world % args.model_parallel or args.candidates * pods != world // args.model_parallel:
            raise ValueError(
                f"{world} ranks at --model-parallel {args.model_parallel} run "
                f"{world / args.model_parallel:g} candidates, one a rank: --candidates "
                f"{args.candidates}{' x 2 pods' if args.multi_pod else ''} does not match")
        if args.layout == "flat" and args.model_parallel == 1 and args.mode == "robust_dp":
            mesh = make_test_mesh(data=args.candidates, pod=2 if args.multi_pod else 0,
                                  group=dist.group.WORLD)
        else:
            mesh = make_grid(args.candidates, args.model_parallel,
                             pod=2 if args.multi_pod else 0)
    else:
        model_group = None
        if args.model_parallel > 1 and dist.is_initialized():
            model_group = dist.group.WORLD
        mesh = make_test_mesh(data=args.candidates, model=args.model_parallel,
                              pod=2 if args.multi_pod else 0, model_group=model_group)

    tc = tr.TrainConfig(
        mode=args.mode,
        agg=RobustAggConfig(
            method=args.agg,
            layout=args.layout,
            wfagg=WFAggConfig(f=args.f, use_temporal=not args.no_temporal,
                              transient=args.transient, window=args.window),
            chunk_size=args.chunk_size,
            sketch_dim=args.sketch_dim,
            backend=args.agg_backend,
        ),
        lr=args.lr, warmup=args.warmup, total_steps=args.steps,
        attack=args.attack, n_malicious=args.n_malicious,
        multi_pod=args.multi_pod,
    )
    return cfg, mesh, tc


def main(argv=None, device=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale variant of the same family")
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=0)
    ap.add_argument("--param-dtype", default="", choices=("", "float32", "bfloat16"),
                    help="the parameters' dtype (default: the config's)")
    ap.add_argument("--optimizer", default="", choices=("", "sgd", "adamw", "adafactor"),
                    help="the optimizer (default: the config's)")
    ap.add_argument("--mode", default="robust_dp", choices=("robust_dp", "gspmd"))
    ap.add_argument("--agg", default="wfagg",
                    choices=("mean", "median", "trimmed_mean", "krum",
                             "multi_krum", "clustering", "wfagg", "alt_wfagg"))
    ap.add_argument("--agg-backend", default="reference",
                    choices=("reference", "fused", "fused_two_launch"),
                    help="the stacked all-reduce's backend (RobustAggConfig.backend)")
    ap.add_argument("--candidates", type=int, default=1,
                    help="candidate workers K on the mesh's data axis")
    ap.add_argument("--f", type=int, default=2)
    ap.add_argument("--no-temporal", action="store_true")
    ap.add_argument("--transient", type=int, default=3)
    ap.add_argument("--window", type=int, default=3)
    ap.add_argument("--layout", default="stacked", choices=("flat", "stacked"),
                    help="robust-agg gradient layout")
    ap.add_argument("--chunk-size", type=int, default=1 << 22)
    ap.add_argument("--sketch-dim", type=int, default=4096)
    ap.add_argument("--attack", default="none",
                    choices=("none", "noise", "sign_flip", "label_flip",
                             "ipm_0.5", "ipm_100", "alie"))
    ap.add_argument("--n-malicious", type=int, default=0)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    dev = resolve_device(device)
    if (dev.type == "cuda" and dist.is_initialized() and dist.get_world_size() > 1
            and "LOCAL_RANK" in os.environ):
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    cfg, mesh, tc = build_everything(args)
    K = tr._n_candidates(mesh, tc)
    main_rank = not dist.is_initialized() or dist.get_rank() == 0
    say = print if main_rank else (lambda *a, **k: None)
    say(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
        f"device={dev} mesh={dict(mesh.shape)} "
        f"mode={tc.mode} agg={tc.agg.method} backend={tc.agg.backend} "
        f"attack={tc.attack} malicious={tc.n_malicious}/{K}")

    state = tr.init_train_state(cfg, tc, torch.Generator(device=dev).manual_seed(0), mesh,
                                device=dev)
    step_fn = tr.build_train_step(cfg, tc, mesh)
    stream = TokenStream(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                         batch_size=args.global_batch)

    t0 = time.time()
    for i in range(args.steps):
        state, m = step_fn(state, stream.batch(i, device=dev))
        if (i + 1) % args.log_every == 0 or i == 0:
            loss = float(m["loss"])
            acc = int(m["n_accepted"])
            dt = time.time() - t0
            say(f"step {i + 1:5d}  loss {loss:8.4f}  "
                f"grad_norm {float(m['grad_norm']):9.3e}  "
                f"accepted {acc}  {dt / (i + 1):6.2f}s/step")
        if args.ckpt_dir and args.ckpt_every and (i + 1) % args.ckpt_every == 0:
            whole = tr.full_params(state.params, mesh)
            if main_rank:
                ckpt.save_checkpoint(args.ckpt_dir, f"step_{i + 1}", whole,
                                     {"step": i + 1, "loss": float(m["loss"])})
    say(f"done: {args.steps} steps, final loss {float(m['loss']):.4f}")


if __name__ == "__main__":
    main()
