"""Multi-process bodies of ``tests/test_torch_spmd.py``: S ``gloo`` ranks
on the CPU, one spawned process each, meeting through a ``FileStore``
under the test's ``tmp_path`` (so concurrent test workers never share a
port).  This module imports torch and ``repro_torch`` only: the spawned
children never import JAX.

``run_ranks(task, S, tmp_path, **kw)`` starts the S processes, waits at
most ``timeout`` seconds for all of them (killing the rest and failing
past it) and returns each rank's result in rank order."""
import os
import pathlib
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 120


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:            # numpy has none: float32 holds it
            x = x.float()
        return x.detach().cpu().numpy().copy()   # never a view of live storage
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return x


def _state_np(st):
    return None if st is None else {k: _np(v) for k, v in st._asdict().items()}


# ---------------------------------------------------------------------------
# tasks (run on every rank after the group is up)
# ---------------------------------------------------------------------------

def task_round(rank, S, cfg, rounds, idx, valid=None, prev0=None):
    """``wfagg_batch_sharded`` over the rounds' model matrices with the
    temporal state carried; per round every output as numpy."""
    from repro_torch.distributed import spmd

    N, K = idx.shape
    d = rounds[0].shape[1]
    state = spmd.batched_matrix_state(N, K, d, cfg.window)
    if prev0 is not None:
        state = state._replace(prev=torch.as_tensor(prev0))
    out = []
    for models in rounds:
        m = torch.as_tensor(models)
        o, state, info = spmd.wfagg_batch_sharded(
            m, m, state, cfg, torch.as_tensor(idx),
            None if valid is None else torch.as_tensor(valid), device="cpu")
        out.append({"out": _np(o), "state": _state_np(state),
                    **{k: _np(v) for k, v in info.items()}})
    return out


def task_scan(rank, S, cfg, models, prev, sched_idx, sched_valid, bad_d):
    """``wfagg_scan_sharded`` on the pre-padded matrix: this rank's shard of
    the models and the state; and whether a d that is not a multiple of S
    raised ValueError."""
    from repro_torch.distributed import spmd

    N, K = sched_idx.shape[1:]
    state = spmd.batched_matrix_state(N, K, models.shape[1], cfg.window)
    state = state._replace(prev=torch.as_tensor(prev))
    m, st = spmd.wfagg_scan_sharded(torch.as_tensor(models), state, cfg,
                                    torch.as_tensor(sched_idx),
                                    torch.as_tensor(sched_valid), device="cpu")
    refused = False
    try:
        spmd.wfagg_scan_sharded(torch.zeros((N, bad_d)), None, cfg,
                                torch.as_tensor(sched_idx), torch.as_tensor(sched_valid),
                                device="cpu")
    except ValueError as e:
        refused = "multiple of the shard count" in str(e)
    return {"models": _np(m), "state": _state_np(st), "refused": refused}


def task_engine(rank, S, cfg, topo, params, sched, batches):
    """The dynamic round of ``dfl.engine`` with ``mesh_model_shards = S``,
    from the given initial parameters and per-round batches: every rank's
    full model matrix, verdicts and WFAgg-T history after each round."""
    from repro_torch.core import wfagg as wf
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.dfl import engine
    from repro_torch.models.lenet import ravel

    fn = engine.build_round_fn(cfg, topo, SyntheticImages(), dynamic=True,
                               telemetry=True, device="cpu")
    st = engine.init_dfl_state(cfg, topo, degree=sched.width, device="cpu")
    st = st._replace(node_params={k: torch.as_tensor(v) for k, v in params.items()})
    prev = (sched.neighbor_idx[0], sched.valid[0])
    out = []
    for r, b in enumerate(batches):
        idx, val, mal = (torch.as_tensor(x[r]) for x in (
            sched.neighbor_idx, sched.valid, sched.malicious))
        st = st._replace(temporal=wf.realign_temporal_history(
            st.temporal, *(torch.as_tensor(x) for x in prev), idx, val))
        st, rec = fn(st, idx, val, mal, batches=b)
        out.append({"flat": _np(ravel(st.node_params)),
                    "momentum": _np(ravel(st.node_momentum)),
                    "verdict": _np(rec.verdict), "hist_s": _np(st.temporal.hist_s)})
        prev = (sched.neighbor_idx[r], sched.valid[r])
    return out


def task_group_size(rank, S, cfg, topo):
    """A group whose size is not the shard count is refused, by
    ``aggregation_group`` and by ``build_round_fn``."""
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.dfl import engine
    from repro_torch.distributed import spmd

    msgs = []
    for call in (lambda: spmd.aggregation_group(S + 1),
                 lambda: engine.build_round_fn(cfg, topo, SyntheticImages(),
                                               device="cpu")):
        try:
            call()
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    return msgs


def task_flat(rank, S, cfg, rounds, malicious, attack):
    """The flat layout on this rank's candidate: ``apply_distributed_attack``
    then ``robust_allreduce`` over the group, the WFAgg-T state carried over
    the rounds; rank 0 also runs the one-process emulation over all S rows.
    Per round the attacked row, the output, the weights, masks and state."""
    from repro_torch.distributed import robust_allreduce as ra

    mal = torch.as_tensor(malicious)

    def run(axis, rows):
        state = ra.init_agg_state(cfg, S)
        out = []
        for x in rounds:
            x = torch.as_tensor(x)
            local = x if isinstance(axis, ra.Emulated) else x[rank]
            g = ra.apply_distributed_attack(local, axis, mal, attack)
            o, state, info = ra.robust_allreduce(g, axis, cfg, state)
            out.append({"attacked": _np(g if rows else g[None]), "out": _np(o),
                        "state": _state_np(state.temporal),
                        **{k: _np(v) for k, v in info.items() if k != "record"}})
        return out

    res = {"rank": run(dist.group.WORLD, False)}
    if rank == 0:
        res["emulated"] = run(ra.Emulated(S), True)
    return res


def _gather_leaves(leaves, model, mesh, lead=0):
    """A model rank's blocks of the tree's leaves (ravel order; ``lead``
    leading axes before each parameter's own), gathered whole over the
    model group, as numpy."""
    from repro_torch.core import flatten as F
    from repro_torch.distributed import sharding as shd

    out = []
    for leaf, c in zip(leaves, F.split_cuts(model)):
        if c is not None:
            cut, whole = c[0].shifted(lead), c[1]
            leaf = shd.gather_tensor(leaf, tuple("model" if i == cut.dim else None
                                                 for i in range(leaf.ndim)), mesh, cut, whole)
        out.append(_np(leaf))
    return out


def _tp_gather(model, mesh, vecs):
    """The whole tree of a model rank's (P_s,) and (P_r,) vectors (a
    gradient) as numpy leaves in ravel order."""
    from repro_torch.core import flatten as F

    tree = F.unravel_rows_split(tuple(v.reshape(1, -1) for v in vecs), model)
    return _gather_leaves([leaf[0] for leaf in F.tree_leaves(tree)], model, mesh)


def _tp_candidates(model, tree, K, rank):
    """The rank's candidate tree laid out on (K, P_s) and (K, P_r) matrices,
    each leaf its block of the whole numpy ``tree`` (leaves (K, ...))."""
    from repro_torch.core import flatten as F

    from repro_torch.distributed import sharding as shd

    mats = [torch.zeros((K, b.numel())) for b in F.layout_split(model)]
    cand = F.unravel_rows_split(tuple(mats), model)
    for dst, src, c in zip(F.tree_leaves(cand), F.tree_leaves(tree), F.split_cuts(model)):
        src = torch.as_tensor(np.array(src))
        if c is not None:
            src = shd.take_block(src, c[0].shifted(1), model.tp.size, rank)
        dst.copy_(src)
    return cand


def _tp_tree_np(tree):
    from repro_torch.core import flatten as F
    return [_np(x) for x in F.tree_leaves(tree)]


def task_tp(rank, S, cfg, params, tokens, parts, cands=None, methods=(), wcfg=None,
            train=None, prompts=None, ckpt_dir=None):
    """The model axis on S ranks (M = S), a dense model from the reference's
    initial ``params`` (numpy): per part in ``parts``, what rank 0 returns
    as numpy, the gathered whole where a rank holds a block.

      forward    the gathered logits of ``tokens``;
      grads      the loss and the gathered gradient leaves (ravel order);
      allreduce  per round of ``cands`` (whole candidate trees) and per
                 (method, backend): the gathered aggregate, weights and
                 masks; WFAgg-T's state carried; also the psum'd
                 statistics of round 0;
      noise      the noise attack's gathered candidates (seed 7);
      train      ``train["steps"]`` steps of the trainer from the
                 reference's state: per step loss, weights, masks, the
                 gathered params; a checkpoint of the last at ``ckpt_dir``
                 (rank 0) and the M = 1 checkpoint at ``ckpt_dir``/m1
                 loaded back;
      launcher   ``launch.train.main`` with ``--model-parallel S`` for 2
                 reduced steps, a checkpoint at ``ckpt_dir``/launcher;
      serve      the gathered prefill logits of ``prompts`` (flash branch
                 at a lowered threshold) and 4 greedy decode steps."""
    import types

    from repro_torch.core import flatten as F
    from repro_torch.distributed import robust_allreduce as ra
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import serve as sv
    from repro_torch.train import trainer as tr

    mesh = make_test_mesh(data=1, model=S, model_group=dist.group.WORLD)
    model = M.params_from_jax(params, cfg, "cpu", mesh=mesh)
    out = {"split_dims": F.split_dims(model)}
    batch = {"tokens": torch.as_tensor(tokens).long()}
    if "forward" in parts:
        logits, _ = M.forward(cfg, model, batch)
        out["logits"] = _np(shd.gather_tensor(logits, (None, None, "model"), mesh))
    if "grads" in parts:
        loss, g = tr.loss_and_grad(cfg, model, batch)
        out["loss"] = float(loss)
        out["grads"] = _tp_gather(model, mesh, g)
    if "allreduce" in parts:
        K = F.tree_leaves(cands[0]["tree"])[0].shape[0]
        shards = ra.ModelShards(mesh.model_axis(), tuple(F.split_dims(model)))
        res = {}
        for method, backend in methods:
            cfg_a = ra.RobustAggConfig(method=method, wfagg=wcfg, backend=backend,
                                       layout="stacked")
            state = ra.init_tree_agg_state(cfg_a, K, F.module_tree(model))._replace(
                prev=_tp_candidates(model, cands[0]["prev"], K, rank))
            rounds = []
            for c in cands:
                cand = _tp_candidates(model, c["tree"], K, rank)
                agg, state, info = ra.robust_allreduce_stacked(cand, cfg_a, state,
                                                               model_shards=shards)
                rounds.append({"out": _gather_leaves(F.tree_leaves(agg), model, mesh),
                               **{k: _np(v) for k, v in info.items() if k != "record"}})
            res[(method, backend)] = rounds
        cand = _tp_candidates(model, cands[0]["tree"], K, rank)
        leaves = F.tree_leaves(cand)
        dims = F.split_dims(model)
        groups = [[l for l, d in zip(leaves, dims) if d is not None],
                  [l for l, d in zip(leaves, dims) if d is None]]
        mats = [ra._concat_candidates(g) for g in groups]
        cfg_s = ra.RobustAggConfig(method="alt_wfagg", backend="fused")
        mine = [0] if rank else [0, 1]
        st = ra.psum_stats(ra._partial_stats(K, "cpu", [groups[i] for i in mine], None, cfg_s,
                                             [mats[i] for i in mine], [None, None]),
                           dist.group.WORLD)
        out["stats"] = {f: _np(getattr(st, f)[0]) for f in ("dist2", "norm2", "gram")}
        out["allreduce"] = res
    if "noise" in parts:
        K = F.tree_leaves(cands[0]["tree"])[0].shape[0]
        cand = _tp_candidates(model, cands[0]["tree"], K, rank)
        shards = ra.ModelShards(mesh.model_axis(), tuple(F.split_dims(model)))
        ra.apply_stacked_attack(cand, torch.tensor([k % 2 == 1 for k in range(K)]), "noise",
                                torch.Generator().manual_seed(7), in_place=True,
                                model_shards=shards)
        out["noise"] = _gather_leaves(F.tree_leaves(cand), model, mesh, lead=1)
    if "train" in parts:
        tc, K = train["tc"], train["K"]
        js = train["state"]
        agg = None if js["agg_state"] is None else types.SimpleNamespace(**js["agg_state"])
        st = tr.state_from_jax(types.SimpleNamespace(
            params=js["params"], opt_state=js["opt_state"], agg_state=agg, step=js["step"]),
            cfg, device="cpu", mesh=make_test_mesh(data=K, model=S,
                                                   model_group=dist.group.WORLD))
        tmesh = make_test_mesh(data=K, model=S, model_group=dist.group.WORLD)
        seen = {}
        step = tr.build_train_step(cfg, tc, tmesh,
                                   observe=lambda phase, **v: seen.update({phase: v}))
        steps = []
        for b in train["batches"]:
            st, m = step(st, {"tokens": torch.as_tensor(b).long()})
            info = seen["allreduce"]["info"]
            steps.append({"loss": float(m["loss"]), "weights": _np(m["weights"]),
                          "grad_norm": float(m["grad_norm"]),
                          "masks": {k: _np(info[k]) for k in ("mask_d", "mask_c", "mask_t")
                                    if k in info},
                          "params": _tp_tree_np(tr.full_params(st.params, tmesh))})
        out["train"] = steps
        whole = tr.full_params(st.params, tmesh)
        if rank == 0:
            ckpt.save_checkpoint(ckpt_dir, "tp", whole, {"model": S})
        dist.barrier()
        m1, _ = ckpt.restore_checkpoint(ckpt_dir + "/m1", "m1", whole)
        tr.load_params_(st.params, m1, tmesh)
        out["loaded"] = _tp_tree_np(tr.full_params(st.params, tmesh))
    if "launcher" in parts:
        from repro_torch.launch import train as T
        T.main(["--reduced", "--d-model", "64", "--n-layers", "2", "--vocab", "128",
                "--candidates", "4", "--steps", "2", "--seq-len", "32", "--global-batch", "4",
                "--agg-backend", "fused", "--attack", "ipm_100", "--n-malicious", "1",
                "--model-parallel", str(S), "--ckpt-dir", ckpt_dir + "/launcher",
                "--ckpt-every", "2"], device="cpu")
    if "serve" in parts:
        L.SDPA_CHUNK_THRESHOLD = 128
        p = torch.as_tensor(prompts).long()
        pre = sv.build_prefill(cfg, device="cpu", mesh=mesh)
        out["prefill"] = _np(pre(model, {"tokens": p}))
        cache = M.init_cache(cfg, p.shape[0], p.shape[1] + 4, device="cpu", mesh=mesh)
        out["cache_heads"] = cache["layers"]["k"].shape[2]
        dec = sv.build_decode_step(cfg, device="cpu", mesh=mesh)
        logits = []
        for i in range(p.shape[1]):
            lg, cache = dec(model, cache, p[:, i:i + 1])
        tok = lg[:, -1].argmax(-1, keepdim=True)
        for _ in range(4):
            logits.append(_np(lg))
            lg, cache = dec(model, cache, tok)
            tok = lg[:, -1].argmax(-1, keepdim=True)
        out["decode"] = logits
    return out


def _grid_column_block(model, tree, K):
    """A grid rank's column block of the whole numpy candidate ``tree``
    (leaves (K, ...)): each leaf cut to the rank's model block, then its
    FSDP block, laid out on the column groups' (K, D) matrices."""
    from repro_torch.core import flatten as F
    from repro_torch.train import trainer as tr

    cand = tr._column_block(model, K, "cpu")
    dims = [model.fsdp.dims[path] for path, _ in F.leaf_params(model)]
    cut = tr._cut({"c": _as_tensors(tree)}, {"c": F.module_tree(model)}, model, lead=1,
                  data=dims)["c"]
    for dst, src in zip(F.tree_leaves(cand), F.tree_leaves(cut)):
        dst.copy_(src)
    return cand


def _as_tensors(tree):
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tensors(v) for v in tree]
    return torch.as_tensor(np.array(tree))


def _grid_whole(model, mesh, tree, lead):
    """The whole leaves (numpy, ravel order) of a grid rank's block tree
    (``lead`` leading axes): gathered over the data group, then the model
    group."""
    from repro_torch.core import flatten as F
    from repro_torch.distributed import sharding as shd

    out = []
    for leaf, (path, _), c in zip(F.tree_leaves(tree), F.leaf_params(model),
                                  F.split_cuts(model)):
        ddim = model.fsdp.dims[path]
        cut = None if c is None else c[0].shifted(lead)
        spec = tuple("model" if i == (None if cut is None else cut.dim) else
                     "data" if i == (None if ddim is None else ddim + lead) else None
                     for i in range(leaf.ndim))
        out.append(_np(shd.gather_tensor(leaf, spec, mesh, cut, 0 if c is None else c[1])))
    return out


def task_grid(rank, S, K, M, cfg, params, parts, runs=(), cands=None, methods=(),
              wcfg=None, prompts=None, ckpt_dir=None, resume=None, fsdp_min_dim=64):
    """The data axis as processes: a K x M grid of S = K * M ranks
    (``launch.mesh.make_grid``), the FSDP rule's threshold lowered to
    ``fsdp_min_dim`` so that the reduced widths split over data; a dense
    model from the reference's initial ``params`` (numpy).  Per part:

      stats      the psum'd statistics of ``cands[0]`` (whole candidate
                 trees, leaves (K, ...)) on the rank's column block;
      allreduce  per (method, backend) of ``methods`` and round of
                 ``cands``: the gathered aggregate, weights and masks;
      noise      the noise attack on the column block of ``cands[0]``
                 (seed 7), gathered whole;
      train      per run of ``runs`` (``tc``, ``state``: the reference's
                 initial state as numpy, ``batches``): per step loss,
                 grad_norm, weights, masks and the gathered params; a
                 run with ``save`` checkpoints its last params at
                 ``ckpt_dir`` (rank 0);
      resume     the checkpoint ``resume`` loaded into a fresh state of
                 ``runs[0]``'s config and one step taken on its first batch;
      launcher   ``launch.train.main`` on the grid for 2 reduced steps, a
                 checkpoint at ``ckpt_dir``/launcher, and a ``--candidates``
                 that does not match the ranks (its error);
      serve      the gathered prefill logits of ``prompts`` (the flash
                 branch at a lowered threshold) and 4 greedy decode steps;
                 the cache's rows a rank."""
    import types

    from repro_torch.core import flatten as F
    from repro_torch.distributed import robust_allreduce as ra
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_grid
    from repro_torch.models import layers as L
    from repro_torch.models import model as Mo
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import serve as sv
    from repro_torch.train import trainer as tr

    shd._FSDP_MIN_DIM = fsdp_min_dim
    mesh = make_grid(K, M)
    out = {}
    model = Mo.params_from_jax(params, cfg, "cpu", mesh=mesh)
    out["groups"] = [len(g) for g in F.fsdp_groups(model)]
    shards = tr.grid_shards(model, mesh)
    out["counted"] = shards.counted
    if "stats" in parts:
        cand = _grid_column_block(model, cands[0]["tree"], K)
        leaves = F.tree_leaves(cand)
        groups = [[l for l, g in zip(leaves, shards.leaf_groups) if g == i]
                  for i in range(len(shards.counted))]
        mine = [i for i, c in enumerate(shards.counted) if c]
        cfg_s = ra.RobustAggConfig(method="alt_wfagg", backend="fused")
        st = ra.psum_stats(ra._partial_stats(
            K, "cpu", [groups[i] for i in mine], None, cfg_s,
            [ra._concat_candidates(groups[i]) if groups[i] else torch.zeros((K, 0))
             for i in mine], [None] * len(mine)), shards.group)
        out["stats"] = {f: _np(getattr(st, f)[0]) for f in ("dist2", "norm2", "gram")}
    if "allreduce" in parts:
        res = {}
        for method, backend in methods:
            cfg_a = ra.RobustAggConfig(method=method, wfagg=wcfg, backend=backend,
                                       layout="stacked")
            state = ra.init_tree_agg_state(cfg_a, K, F.module_tree(model))._replace(
                prev=_grid_column_block(model, cands[0]["prev"], K))
            rounds = []
            for c in cands:
                cand = _grid_column_block(model, c["tree"], K)
                agg, state, info = ra.robust_allreduce_stacked(cand, cfg_a, state,
                                                               model_shards=shards)
                rounds.append({"out": _grid_whole(model, mesh, agg, 0),
                               **{k: _np(v) for k, v in info.items() if k != "record"}})
            res[(method, backend)] = rounds
        out["allreduce"] = res
    if "noise" in parts:
        cand = _grid_column_block(model, cands[0]["tree"], K)
        ra.apply_stacked_attack(cand, torch.tensor([k % 2 == 1 for k in range(K)]), "noise",
                                torch.Generator().manual_seed(7), in_place=True,
                                model_shards=shards)
        out["noise"] = _grid_whole(model, mesh, cand, 1)
    if "train" in parts or "resume" in parts:
        out["train"] = []
        for run in runs:
            tc, js = run["tc"], run["state"]
            agg = None if js["agg_state"] is None else types.SimpleNamespace(**js["agg_state"])
            st = tr.state_from_jax(types.SimpleNamespace(
                params=js["params"], opt_state=js["opt_state"], agg_state=agg,
                step=js["step"]), cfg, device="cpu", mesh=mesh, tc=tc)
            seen = {}
            step = tr.build_train_step(cfg, tc, mesh,
                                       observe=lambda phase, **v: seen.update({phase: v}))
            batches = run["batches"]
            if "resume" in parts:
                whole = tr.full_params(st.params, mesh)
                tree, _ = ckpt.restore_checkpoint(resume, "grid", whole)
                tr.load_params_(st.params, tree, mesh)
                batches = batches[:1]
            steps = []
            for b in batches:
                st, m = step(st, {"tokens": torch.as_tensor(b).long()})
                info = seen["allreduce"]["info"]
                steps.append({"loss": float(m["loss"]), "weights": _np(m["weights"]),
                              "grad_norm": float(m["grad_norm"]),
                              "masks": {k: _np(info[k]) for k in ("mask_d", "mask_c",
                                                                  "mask_t") if k in info},
                              "params": _tp_tree_np(tr.full_params(st.params, mesh))})
            out["train"].append(steps)
            if run.get("save"):
                whole = tr.full_params(st.params, mesh)
                if rank == 0:
                    ckpt.save_checkpoint(ckpt_dir, "grid", whole, {"grid": [K, M]})
                dist.barrier()
            if "resume" in parts:
                break
    if "launcher" in parts:
        from repro_torch.launch import train as T
        argv = ["--reduced", "--d-model", "64", "--n-layers", "2", "--vocab", "128",
                "--steps", "2", "--seq-len", "32", "--global-batch", "4",
                "--agg-backend", "fused", "--attack", "ipm_100", "--n-malicious", "1",
                "--model-parallel", str(M), "--ckpt-dir", ckpt_dir + "/launcher",
                "--ckpt-every", "2"]
        T.main(argv + ["--candidates", str(K)], device="cpu")
        try:
            T.main(argv + ["--candidates", str(K + 1)], device="cpu")
            out["mismatch"] = None
        except ValueError as e:
            out["mismatch"] = str(e)
    if "serve" in parts:
        L.SDPA_CHUNK_THRESHOLD = 128
        model = Mo.params_from_jax(params, cfg, "cpu", mesh=mesh)
        p = torch.as_tensor(prompts).long()
        pre = sv.build_prefill(cfg, device="cpu", mesh=mesh)
        out["prefill"] = _np(pre(model, {"tokens": p}))
        out["blocks_after"] = bool(model.fsdp_blocks)
        cache = Mo.init_cache(cfg, p.shape[0], p.shape[1] + 4, device="cpu", mesh=mesh)
        out["cache_rows"] = cache["layers"]["k"].shape[1]
        dec = sv.build_decode_step(cfg, device="cpu", mesh=mesh)
        for i in range(p.shape[1]):
            lg, cache = dec(model, cache, p[:, i:i + 1])
        tok = lg[:, -1].argmax(-1, keepdim=True)
        logits = []
        for _ in range(4):
            logits.append(_np(lg))
            lg, cache = dec(model, cache, tok)
            tok = lg[:, -1].argmax(-1, keepdim=True)
        out["decode"] = logits
    return out


def _batch(tokens, extra=None, rows=None):
    """A batch of ``tokens`` (numpy) and the numpy entries of ``extra``
    (``frames``, ``patch_embeds``) as tensors; ``rows`` (first, count): those
    rows of every entry."""
    b = {"tokens": torch.as_tensor(tokens).long(),
         **{k: torch.as_tensor(v) for k, v in (extra or {}).items()}}
    if rows is not None:
        b = {k: v[rows[0]:rows[0] + rows[1]] for k, v in b.items()}
    return b


def task_fam(rank, S, runs, mesh_shape, fsdp_min_dim=64, remat_check=None, launcher=None,
             sketch=None, launcher_raises=None):
    """The MoE, SSM, hybrid, encoder-decoder and VLM families on a mesh of S
    ranks: ``mesh_shape`` (K, M), a K x M grid when K > 1
    (``launch.mesh.make_grid``, the FSDP threshold lowered to
    ``fsdp_min_dim``), else the model axis of M = S.  Per run of ``runs``
    (a dict: ``cfg``, the reference's initial ``params`` as numpy,
    ``tokens``, ``prompts``, ``parts``, ``train``'s and ``flat``'s ``tc`` /
    ``state`` / ``batches`` / ``K``, and, for the encoder-decoder and the
    VLM, ``extra`` / ``prompt_extra`` and the training runs' ``extras``:
    the ``frames`` or ``patch_embeds`` beside the tokens), what rank 0
    returns, gathered whole where a rank holds a block:

      forward    the logits of ``tokens`` and the aux loss;
      grads      (model axis) the loss and the gradient leaves;
      roundtrip  every parameter leaf gathered (``trainer.full_params``)
                 and the rank's blocks of that tree cut again
                 (``load_params_``): whether both are bit-equal; and the
                 gathered leaves of ``init_params(mesh=)`` from seed 0;
      stats      the psum'd statistics of ``cands`` (whole candidate
                 trees) on the rank's blocks;
      train      per step loss, grad_norm, weights, masks and the params;
                 the last params saved at ``ckpt`` (rank 0) and the
                 checkpoint ``load`` loaded back;
      flat       ``flat``'s steps (a flat-layout ``tc``), as ``train``'s;
      serve      the prefill logits of ``prompts`` (flash branch at a
                 lowered threshold, kernel 8's plain version), and the
                 decode of the prompts' first ``decode_len`` tokens then 4
                 greedy steps (an encoder-decoder's cache holding the
                 encoded ``frames`` of the prompts: ``enc_out``).
    ``remat_check``: a run index whose gradients are taken again with
    ``cfg.remat`` on (``grads_remat``).  ``launcher``: (arch, checkpoint
    directory) for ``launch.train.main`` with ``--model-parallel M``, 2
    reduced steps, the last checkpointed; ``launcher_raises``: an arch
    whose launcher run's error is returned (``launcher_error``).
    ``sketch``: the count-sketch's buckets and signs per whole-vector
    chunk (numpy), installed as ``robust_allreduce.sketch_hash``."""
    import dataclasses
    import types

    from repro_torch.core import flatten as F
    from repro_torch.distributed import robust_allreduce as ra
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_grid, make_test_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import model as Mo
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import serve as sv
    from repro_torch.train import trainer as tr

    if sketch is not None:
        table = {ci: (torch.as_tensor(b), torch.as_tensor(sg)) for ci, (b, sg) in sketch.items()}
        ra.sketch_hash = lambda n, m, seed, ci, device: table[ci]
    K, M = mesh_shape
    grid = K > 1
    if grid:
        shd._FSDP_MIN_DIM = fsdp_min_dim
        mesh = make_grid(K, M)
    else:
        mesh = make_test_mesh(data=1, model=M, model_group=dist.group.WORLD)

    def trajectory(cfg, t):
        js = t["state"]
        agg = None if js["agg_state"] is None else types.SimpleNamespace(**js["agg_state"])
        tmesh = mesh if grid else make_test_mesh(data=t["K"], model=M,
                                                 model_group=dist.group.WORLD)
        st = tr.state_from_jax(types.SimpleNamespace(
            params=js["params"], opt_state=js["opt_state"], agg_state=agg,
            step=js["step"]), cfg, device="cpu", mesh=tmesh, tc=t["tc"])
        seen = {}
        step = tr.build_train_step(cfg, t["tc"], tmesh,
                                   observe=lambda phase, **v: seen.update({phase: v}))
        steps = []
        extras = t.get("extras") or [None] * len(t["batches"])
        for b, x in zip(t["batches"], extras):
            st, m = step(st, _batch(b, x))
            info = seen["allreduce"]["info"]
            steps.append({"loss": float(m["loss"]), "weights": _np(m["weights"]),
                          "grad_norm": float(m["grad_norm"]),
                          "masks": {k: _np(info[k]) for k in ("mask_d", "mask_c",
                                                              "mask_t") if k in info},
                          "params": _tp_tree_np(tr.full_params(st.params, tmesh))})
        return st, tmesh, steps

    results = []
    for i, run in enumerate(runs):
        cfg, params, parts = run["cfg"], run["params"], run["parts"]
        out = {}
        model = Mo.params_from_jax(params, cfg, "cpu", mesh=mesh)
        if not grid:
            out["split_dims"] = F.split_dims(model)
        if "forward" in parts:
            L.SDPA_CHUNK_THRESHOLD = 8192
            B = run["tokens"].shape[0]
            logits, aux = Mo.forward(cfg, model, _batch(run["tokens"], run.get("extra"),
                                                        Mo.local_rows(B, mesh)))
            out["logits"] = _np(sv._gathered(logits, mesh, B))
            out["aux"] = float(aux) if Mo.local_rows(B, mesh)[1] == B else None
        if "grads" in parts:
            for key, c in (("grads", cfg), ("grads_remat", dataclasses.replace(cfg, remat=True))):
                if key == "grads_remat" and remat_check != i:
                    continue
                loss, g = tr.loss_and_grad(c, model, _batch(run["tokens"], run.get("extra")))
                out[key] = (float(loss), _tp_gather(model, mesh, g))
        if "roundtrip" in parts:
            whole = tr.full_params(model, mesh)
            same = all(np.array_equal(_np(a), np.asarray(b)) for a, b in
                       zip(F.tree_leaves(whole), F.tree_leaves(_as_tensors(params))))
            before = [_np(x) for x in F.tree_leaves(F.module_tree(model))]
            tr.load_params_(model, whole, mesh)
            after = [_np(x) for x in F.tree_leaves(F.module_tree(model))]
            out["roundtrip"] = same and all(np.array_equal(a, b) for a, b in zip(before, after))
            # the port's own init on the mesh: drawn one block at a time and cut
            drawn = Mo.init_params(cfg, torch.Generator().manual_seed(0), "cpu", mesh=mesh)
            out["init"] = [_np(x) for x in F.tree_leaves(tr.full_params(drawn, mesh))]
        if "stats" in parts:
            cands = run["cands"]
            Kc = F.tree_leaves(cands)[0].shape[0]
            cfg_s = ra.RobustAggConfig(method="alt_wfagg", backend="fused")
            if grid:
                shards = tr.grid_shards(model, mesh)
                cand = _grid_column_block(model, cands, Kc)
            else:
                shards = ra._as_grid(ra.ModelShards(mesh.model_axis(),
                                                    tuple(tr._model_cuts(model))))
                cand = _tp_candidates(model, cands, Kc, mesh.model_axis().rank)
            leaves = F.tree_leaves(cand)
            groups = [[l for l, g in zip(leaves, shards.leaf_groups) if g == j]
                      for j in range(len(shards.counted))]
            mine = [j for j, c in enumerate(shards.counted) if c]
            st = ra.psum_stats(ra._partial_stats(
                Kc, "cpu", [groups[j] for j in mine], None, cfg_s,
                [ra._concat_candidates(groups[j]) if groups[j] else torch.zeros((Kc, 0))
                 for j in mine], [None] * len(mine)), shards.group)
            out["stats"] = {f: _np(getattr(st, f)[0]) for f in ("dist2", "norm2", "gram")}
        if "flat" in parts:
            out["flat"] = trajectory(cfg, run["flat"])[2]
        if "train" in parts:
            t = run["train"]
            st, tmesh, out["train"] = trajectory(cfg, t)
            whole = tr.full_params(st.params, tmesh)
            if rank == 0:
                ckpt.save_checkpoint(t["ckpt"], "fam", whole, {"mesh": [K, M]})
            dist.barrier()
            tree, _ = ckpt.restore_checkpoint(t["load"], "one", whole)
            tr.load_params_(st.params, tree, tmesh)
            out["loaded"] = _tp_tree_np(tr.full_params(st.params, tmesh))
        if "serve" in parts:
            L.SDPA_CHUNK_THRESHOLD = 128
            model = Mo.params_from_jax(params, cfg, "cpu", mesh=mesh)
            pb = _batch(run["prompts"], run.get("prompt_extra"))
            out["prefill"] = _np(sv.build_prefill(cfg, device="cpu", mesh=mesh)(model, pb))
            p = pb["tokens"][:, :run["decode_len"]]
            frames = pb.get("frames")
            cache = Mo.init_cache(cfg, p.shape[0], p.shape[1] + 4, device="cpu", mesh=mesh,
                                  enc_len=0 if frames is None else frames.shape[1])
            if frames is not None:
                # the caller fills the encoder output (the reference never does)
                a, n = Mo.local_rows(p.shape[0], mesh)
                with torch.no_grad():
                    cache["enc_out"].copy_(Mo._encode(cfg, model, frames[a:a + n]))
            out["cache"] = {"/".join(map(str, k)): tuple(v.shape)
                            for k, v in _cache_leaves(cache)}
            dec = sv.build_decode_step(cfg, device="cpu", mesh=mesh)
            for j in range(p.shape[1]):
                lg, cache = dec(model, cache, p[:, j:j + 1])
            tok = lg[:, -1].argmax(-1, keepdim=True)
            logits = []
            for _ in range(4):
                logits.append(_np(lg))
                lg, cache = dec(model, cache, tok)
                tok = lg[:, -1].argmax(-1, keepdim=True)
            out["decode"] = logits
        results.append(out)
    if launcher or launcher_raises:
        from repro_torch.launch import train as T

        def launch(arch, ckpt_dir):
            T.main(["--arch", arch, "--reduced", "--candidates", "4", "--steps", "2",
                    "--seq-len", "32", "--global-batch", "4", "--agg-backend", "fused",
                    "--attack", "ipm_100", "--n-malicious", "1", "--model-parallel", str(M),
                    "--ckpt-dir", ckpt_dir, "--ckpt-every", "2"], device="cpu")

        if launcher:
            launch(*launcher)
        if launcher_raises:
            try:
                launch(launcher_raises, "")
                results.append({"launcher_error": None})
            except Exception as e:   # noqa: BLE001 - the test reads which
                results.append({"launcher_error": repr(e)})
    return results


def _tp_mats(model, tree, K, rank):
    """The rank's (K, P_s) and (K, P_r) candidate matrices of the whole numpy
    candidate ``tree`` (leaves (K, ...)), each leaf its block."""
    from repro_torch.core import flatten as F

    cand = _tp_candidates(model, tree, K, rank)
    leaves = F.tree_leaves(cand)
    dims = F.split_dims(model)
    mats = []
    for want in (True, False):
        ls = [leaf for leaf, d in zip(leaves, dims) if (d is not None) == want]
        mats.append(torch.cat([leaf.reshape(K, -1) for leaf in ls], 1) if ls
                    else torch.zeros((K, 0)))
    return tuple(mats)


def _whole_rows(model, mesh, mats):
    """The whole candidates (numpy (K', P) in ravel order) of a rank's (K',
    P_s) and (K', P_r) matrices, gathered over the model group."""
    from repro_torch.core import flatten as F

    tree = F.unravel_rows_split(tuple(m.contiguous() for m in mats), model)
    leaves = _gather_leaves(F.tree_leaves(tree), model, mesh, lead=1)
    K = mats[0].shape[0]
    return np.concatenate([leaf.reshape(K, -1) for leaf in leaves], 1)


def task_flatmesh(rank, S, K, M, flat=(), train=(), stacked=(), adafactor=None, sketch=None,
                  launcher=None):
    """The flat layout, the adaptive attacks, ``gather_dtype`` and
    Adafactor on the model axis (``K`` = 1: the K candidates emulated on M
    = S ranks) or on a K x M grid (S = K * M ranks, one candidate a rank).
    ``sketch``: the count-sketch's buckets and signs per whole-vector chunk
    (numpy), installed as ``robust_allreduce.sketch_hash``.  What rank 0
    returns, gathered whole, per part:

      flat       per run of ``flat`` (``cfg``, ``params``, ``agg`` a
                 ``RobustAggConfig``, ``attack``, ``malicious``, ``rounds``
                 of whole candidate trees with leaves (Kc, ...)): per round
                 the attacked candidates (emulated only), the aggregate
                 (ravel order), weights, masks and the WFAgg-T state;
      train      per run of ``train`` (``cfg``, ``tc``, ``K``, ``state``
                 the reference's as numpy, ``batches``): per step loss,
                 grad_norm, weights, masks, the agg state and the params;
      stacked    per run of ``stacked`` (``cfg``, ``params``, ``tree``, and
                 ``attack`` / ``malicious`` or ``agg`` / ``prev``):
                 ``apply_stacked_attack`` on the rank's blocks (the model
                 axis: ``ModelShards``; the grid: the column block)
                 gathered, or two rounds of the stacked all-reduce from
                 ``prev`` (the aggregate, weights and masks) with the
                 first round's psum'd statistics;
      adafactor  ``adafactor`` (``cfg``, ``params``, ``grads`` a list of
                 whole gradient trees, ``fsdp``): that many optimizer
                 steps on the rank's blocks from a zero state, the updates
                 and the state gathered whole;
      launcher   ``launch.train.main`` with ``--layout flat
                 --model-parallel M`` for 2 reduced steps (``K``
                 candidates on the grid, 4 emulated on the model axis),
                 the last checkpointed at ``launcher`` (the chunk and sketch
                 widths those of ``sketch``'s table)."""
    import types

    from repro_torch.core import flatten as F
    from repro_torch.distributed import robust_allreduce as ra
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_grid, make_test_mesh
    from repro_torch.models import model as Mo
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.train import trainer as tr

    if sketch is not None:
        table = {ci: (torch.as_tensor(b), torch.as_tensor(sg)) for ci, (b, sg) in sketch.items()}
        ra.sketch_hash = lambda n, m, seed, ci, device: table[ci]
    grid = K > 1
    if grid:
        shd._FSDP_MIN_DIM = 64
        mesh = make_grid(K, M)
    else:
        mesh = make_test_mesh(data=1, model=M, model_group=dist.group.WORLD)
    maxis = mesh.model_axis()
    dax = mesh.data_axis()
    out = {}
    if flat:
        res = []
        for run in flat:
            cfg = run["cfg"]
            model = Mo.params_from_jax(run["params"], cfg, "cpu", mesh=mesh, fsdp=None)
            shards = tr.flat_shards(model, mesh)
            Kc = F.tree_leaves(run["rounds"][0])[0].shape[0]
            axis = ra.Emulated(Kc) if dax is None else dax.group
            mal = torch.as_tensor(run["malicious"])
            state = ra.init_agg_state(run["agg"], Kc)
            rounds = []
            for i, tree in enumerate(run["rounds"]):
                mats = _tp_mats(model, tree, Kc, maxis.rank)
                local = mats if dax is None else tuple(m[dax.rank] for m in mats)
                local = ra.apply_distributed_attack(
                    local, axis, mal, run["attack"], torch.Generator().manual_seed(7 + i),
                    chunk_size=run["agg"].chunk_size, in_place=True, model_shards=shards)
                o, state, info = ra.robust_allreduce(local, axis, run["agg"], state,
                                                     model_shards=shards)
                r = {"out": _whole_rows(model, mesh, tuple(v[None] for v in o))[0],
                     "state": _state_np(state.temporal) if state is not None else None,
                     **{k: _np(v) for k, v in info.items() if k != "record"}}
                if dax is None:
                    r["attacked"] = _whole_rows(model, mesh, local)
                rounds.append(r)
            res.append(rounds)
        out["flat"] = res
    if train:
        res = []
        for run in train:
            cfg, tc, js = run["cfg"], run["tc"], run["state"]
            tmesh = mesh if grid else make_test_mesh(data=run["K"], model=M,
                                                     model_group=dist.group.WORLD)
            agg = js["agg_state"]
            if agg is not None:
                agg = (types.SimpleNamespace(temporal=tuple(agg["temporal"]))
                       if "temporal" in agg else types.SimpleNamespace(**agg))
            st = tr.state_from_jax(types.SimpleNamespace(
                params=js["params"], opt_state=js["opt_state"], agg_state=agg,
                step=js["step"]), cfg, device="cpu", mesh=tmesh, tc=tc)
            seen = {}
            step = tr.build_train_step(cfg, tc, tmesh,
                                       observe=lambda phase, **v: seen.update({phase: v}))
            steps = []
            for b in run["batches"]:
                st, m = step(st, {"tokens": torch.as_tensor(b).long()})
                info = seen["allreduce"]["info"]
                steps.append({"loss": float(m["loss"]), "weights": _np(m["weights"]),
                              "grad_norm": float(m["grad_norm"]),
                              "masks": {k: _np(info[k]) for k in ("mask_d", "mask_c",
                                                                  "mask_t") if k in info},
                              "agg": None if st.agg_state is None else
                              _state_np(getattr(st.agg_state, "temporal", st.agg_state)),
                              "params": _tp_tree_np(tr.full_params(st.params, tmesh))})
            res.append(steps)
        out["train"] = res
    if stacked:
        res = []
        for run in stacked:
            cfg = run["cfg"]
            model = Mo.params_from_jax(run["params"], cfg, "cpu", mesh=mesh,
                                       fsdp=False if grid else None)
            Kc = F.tree_leaves(run["tree"])[0].shape[0]
            if grid:
                shards = tr.grid_shards(model, mesh)
                block = lambda t: _grid_column_block(model, t, Kc)  # noqa: E731
                whole = lambda t, lead: _grid_whole(model, mesh, t, lead)  # noqa: E731
            else:
                shards = ra.ModelShards(maxis, tuple(tr._model_cuts(model)))
                block = lambda t: _tp_candidates(model, t, Kc, maxis.rank)  # noqa: E731
                whole = lambda t, lead: _gather_leaves(F.tree_leaves(t), model, mesh,  # noqa
                                                       lead=lead)
            cand = block(run["tree"])
            if run.get("attack"):
                ra.apply_stacked_attack(cand, torch.as_tensor(run["malicious"]), run["attack"],
                                        in_place=True, model_shards=shards)
                res.append(whole(cand, 1))
                continue
            cfg_a = run["agg"]
            state = ra.init_tree_agg_state(cfg_a, Kc, F.module_tree(model))._replace(
                prev=block(run["prev"]))
            g = ra._as_grid(shards)
            leaves, pleaves = F.tree_leaves(cand), F.tree_leaves(state.prev)
            mine = [j for j, c in enumerate(g.counted) if c]
            groups = [[x for x, j in zip(leaves, g.leaf_groups) if j == i] for i in mine]
            pgroups = [[x for x, j in zip(pleaves, g.leaf_groups) if j == i] for i in mine]
            st = ra.psum_stats(ra._partial_stats(
                Kc, "cpu", groups, pgroups, cfg_a,
                [ra._concat_candidates(x) if x else torch.zeros((Kc, 0)) for x in groups],
                [ra._concat_candidates(x) if x else torch.zeros((Kc, 0)) for x in pgroups]),
                g.group)
            rounds = []
            for tree in (run["tree"], run["tree2"]):
                o, state, info = ra.robust_allreduce_stacked(block(tree), cfg_a, state,
                                                             model_shards=shards)
                rounds.append({"out": whole(o, 0),
                               **{k: _np(v) for k, v in info.items() if k != "record"}})
            res.append({"rounds": rounds, "stats": {
                f: _np(getattr(st, f)[0]) for f in ("dist2", "dotmed", "mednorm2", "norm2",
                                                    "gram", "prev_dist2", "prev_dot")}})
        out["stacked"] = res
    if adafactor is not None:
        a = adafactor
        model = Mo.params_from_jax(a["params"], a["cfg"], "cpu", mesh=mesh,
                                   fsdp=a["fsdp"] if grid else None)
        tree = F.module_tree(model)
        opt = opt_lib.make_optimizer("adafactor", blocks=tr.opt_blocks(model))
        state = opt.init(tree)
        lr = torch.tensor(1e-2)
        ups = []
        dims = tr._data_dims(model)
        for g in a["grads"]:
            gb = tr._cut({"g": _as_tensors(g)}, {"g": tree}, model, data=dims)["g"]
            upd, state = opt.update(gb, state, tree, lr)
            ups.append(_grid_whole(model, mesh, upd, 0) if grid else
                       _gather_leaves(F.tree_leaves(upd), model, mesh))
        factors = []
        for (path, ps), c, dd, v in zip(F.leaf_params(model), F.split_cuts(model), dims,
                                        state["v"]):
            nd = len(F.leaf_shape(path, ps))
            keeps = {"v": list(range(nd)), "vr": list(range(nd - 1)),
                     "vc": list(range(nd - 2)) + [nd - 1]}
            got = {}
            for k, x in v.items():
                keep = keeps[k]
                if dd is not None and dd in keep:
                    x = torch.cat(_all_gather(x, dax.group), keep.index(dd))
                if c is not None and c[0].dim in keep:
                    x = shd.join_blocks(_all_gather(x, maxis.group),
                                        c[0]._replace(dim=keep.index(c[0].dim)))
                got[k] = _np(x)
            factors.append(got)
        out["adafactor"] = {"updates": ups, "factors": factors,
                            "factored": [("vr" in v) for v in state["v"]]}
    if launcher:
        from repro_torch.launch import train as T
        T.main(["--reduced", "--d-model", "64", "--n-layers", "2", "--vocab", "128",
                "--candidates", str(K if grid else 4), "--steps", "2", "--seq-len", "32",
                "--global-batch", str(2 * (K if grid else 4)), "--layout", "flat",
                "--chunk-size", "2048", "--sketch-dim", "128", "--attack", "ipm_100",
                "--n-malicious", "1", "--f", "1", "--model-parallel", str(M),
                "--ckpt-dir", launcher, "--ckpt-every", "2"], device="cpu")
    return out


def task_bf16pad(rank, S, runs, mesh_shape, fsdp_min_dim=64, noise=None, opt=()):
    """bf16 parameters and a padded layout's head slots on a mesh of S
    ranks: ``mesh_shape`` (K, M), a K x M grid when K > 1 (``make_grid``,
    the FSDP threshold lowered to ``fsdp_min_dim``), else the model axis
    of M = S with each run's K candidates emulated.  What each rank
    returns (whole trees gathered, as float32 numpy):

      runs   per run (``cfg``, ``tc``, ``K``, ``state`` the reference's
             initial state as numpy, ``batches``, ``route``): per step the
             loss, weights, masks, grad_norm, the gathered parameters, the
             largest |value| of the rank's pad head slots in its
             parameters and in its candidate rows (``pad``); with
             ``route`` (the model axis) also the whole candidates after
             the attack (K, P) in ravel order, the agg state going in and
             the gathered aggregate (P,);
      noise  (``noise``: ``cfg``, ``params``, ``tree`` whole candidates
             (K, ...), ``K``, ``chunk``) the noise attack of seed 7 on
             the rank's blocks, stacked (the column block on a grid) and
             flat (the model axis), gathered whole, and the largest
             ``torch.randn`` draw it made;
      opt    per entry of ``opt`` (``cfg``, ``state``, ``grads`` a whole
             aggregate tree, ``lr``, ``tc``): the rank's optimizer on its
             blocks of ``grads`` from ``state``, the parameters after
             ``p + u`` gathered whole."""
    import types

    from repro_torch.core import flatten as F
    from repro_torch.distributed import robust_allreduce as ra
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_grid, make_test_mesh
    from repro_torch.models import model as Mo
    from repro_torch.optim.optimizers import make_optimizer
    from repro_torch.train import trainer as tr

    Kg, M = mesh_shape
    grid = Kg > 1
    if grid:
        shd._FSDP_MIN_DIM = fsdp_min_dim

    def mesh_of(K):
        if grid:
            return make_grid(Kg, M)
        return make_test_mesh(data=K, model=M, model_group=dist.group.WORLD)

    def state_of(cfg, tc, mesh, js):
        agg = None if js["agg_state"] is None else types.SimpleNamespace(**js["agg_state"])
        return tr.state_from_jax(types.SimpleNamespace(
            params=js["params"], opt_state=js["opt_state"], agg_state=agg,
            step=js["step"]), cfg, device="cpu", mesh=mesh, tc=tc)

    def whole(leaves, model, mesh, lead):
        return _gather_leaves(leaves, model, mesh, lead=lead)

    def ravel(leaves, K=None):
        return np.concatenate([x.reshape(K, -1) if K else x.reshape(-1) for x in leaves], -1)

    def pad_max(tree, tails, lead):
        m = 0.0
        for leaf, t in zip(F.tree_leaves(tree), tails):
            if t is not None:
                d, live = t
                tail = leaf.narrow(lead + d, live, leaf.shape[lead + d] - live)
                m = max(m, float(tail.abs().max()) if tail.numel() else 0.0)
        return m

    out = {"runs": []}
    for run in runs:
        cfg, tc, K = run["cfg"], run["tc"], run["K"]
        mesh = mesh_of(K)
        st = state_of(cfg, tc, mesh, run["state"])
        model = st.params
        tails = F.pad_tails(model)
        seen = {}

        def observe(phase, **v):
            if phase == "grads" and not grid:
                seen["pad_grads"] = pad_max(v["candidates"], tails, 1) if isinstance(
                    v["candidates"], dict) else pad_max(F.unravel_rows_split(
                        tuple(v["candidates"]), model), tails, 1)
            if phase == "attack" and run.get("route"):
                c = v["candidates"]
                if isinstance(c, dict):
                    seen["cands"] = ravel(whole(F.tree_leaves(c), model, mesh, 1), K)
                else:
                    seen["cands"] = _whole_rows(model, mesh, c)
                a = v["agg_state"]
                seen["state"] = None if a is None else (
                    {f: _np(getattr(a.temporal, f)) for f in a.temporal._fields}
                    if hasattr(a, "temporal") else
                    {f: _np(getattr(a, f)) for f in ("hist_s", "hist_b", "count", "t")})
            if phase == "allreduce":
                seen["info"] = v["info"]
                if run.get("route"):
                    g = v["grads"]
                    if isinstance(g, dict):
                        seen["agg"] = ravel(whole(F.tree_leaves(g), model, mesh, 0))
                    else:
                        seen["agg"] = ravel(_tp_gather(model, mesh, g))

        step = tr.build_train_step(cfg, tc, mesh, observe=observe)
        steps = []
        for b in run["batches"]:
            seen.clear()
            st, m = step(st, {"tokens": torch.as_tensor(b).long()})
            info = seen["info"]
            rec = {"loss": float(m["loss"]), "weights": _np(m["weights"]),
                   "grad_norm": float(m["grad_norm"]),
                   "masks": {k: _np(info[k]) for k in ("mask_d", "mask_c", "mask_t")
                             if k in info},
                   "params": [_np(x) for x in F.tree_leaves(tr.full_params(st.params, mesh))],
                   "pad": (pad_max(F.module_tree(st.params), tails, 0),
                           seen.get("pad_grads", 0.0)),
                   "pad_leaves": sum(t is not None for t in tails),
                   "dtypes": sorted({str(p.dtype) for p in st.params.parameters()})}
            for k in ("cands", "state", "agg"):
                if k in seen:
                    rec[k] = seen[k]
            steps.append(rec)
        out["runs"].append(steps)
    if noise is not None:
        cfg, K = noise["cfg"], noise["K"]
        mesh = mesh_of(K)
        model = Mo.params_from_jax(noise["params"], cfg, "cpu", mesh=mesh,
                                   fsdp=True if grid else None)
        mal = torch.tensor([k % 2 == 1 for k in range(K)])
        draws = []
        randn = torch.randn

        def counted(*a, **kw):
            x = randn(*a, **kw)
            draws.append(x.numel())
            return x
        torch.randn = counted
        try:
            if grid:
                shards = tr.grid_shards(model, mesh)
                cand = _grid_column_block(model, noise["tree"], K)
                ra.apply_stacked_attack(cand, mal, "noise", torch.Generator().manual_seed(7),
                                        in_place=True, model_shards=shards,
                                        chunk_size=noise["chunk"])
                out["noise"] = {"stacked": _grid_whole(model, mesh, cand, 1)}
            else:
                F.layout_split(model)
                shards = ra.ModelShards(mesh.model_axis(), tuple(tr._model_cuts(model)),
                                        tuple(tr.whole_shapes(model)))
                cand = _tp_candidates(model, noise["tree"], K, rank)
                ra.apply_stacked_attack(cand, mal, "noise", torch.Generator().manual_seed(7),
                                        in_place=True, model_shards=shards,
                                        chunk_size=noise["chunk"])
                stacked = whole(F.tree_leaves(cand), model, mesh, 1)
                mats = _tp_mats(model, noise["tree"], K, rank)
                ra.apply_distributed_attack(
                    mats, ra.Emulated(K), mal, "noise", torch.Generator().manual_seed(7),
                    chunk_size=noise["chunk"], in_place=True,
                    model_shards=tr.flat_shards(model, mesh))
                out["noise"] = {"stacked": stacked, "flat": _whole_rows(model, mesh, mats)}
        finally:
            torch.randn = randn
        out["noise"]["largest_draw"] = max(draws)
    out["opt"] = []
    for o in opt:
        cfg, tc = o["cfg"], o["tc"]
        mesh = mesh_of(o["K"])
        st = state_of(cfg, tc, mesh, o["state"])
        params = F.module_tree(st.params)
        dims = tr._data_dims(st.params) if st.params.fsdp_blocks else None
        grads = tr._cut(_as_tensors(o["grads"]), params, st.params, data=dims)
        grads = F.tree_map(lambda g, p: torch.as_tensor(np.asarray(g, np.float32)).to(p.dtype),
                           grads, params)
        opt_ = make_optimizer(cfg.optimizer, blocks=tr.opt_blocks(st.params))
        upd, _ = opt_.update(grads, st.opt_state, params,
                             torch.as_tensor(o["lr"], dtype=torch.float32))
        with torch.no_grad():
            for p, u in zip(F.tree_leaves(params), F.tree_leaves(upd)):
                p.add_(u.to(p.dtype))
        out["opt"].append([_np(x) for x in F.tree_leaves(tr.full_params(st.params, mesh))])
    return out


def _all_gather(x, group):
    from repro_torch.distributed.spmd import all_gather_in_rank_order
    return all_gather_in_rank_order(x.contiguous(), group)


def _cache_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _cache_leaves(tree[k], prefix + (k,))]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree) for kv in _cache_leaves(v, prefix + (i,))]
    return [(prefix, tree)] if isinstance(tree, torch.Tensor) else []


TASKS = {"bf16pad": task_bf16pad, "fam": task_fam, "round": task_round, "scan": task_scan, "engine": task_engine,
         "group_size": task_group_size, "flat": task_flat, "tp": task_tp, "grid": task_grid,
         "flatmesh": task_flatmesh}


# ---------------------------------------------------------------------------
# process plumbing
# ---------------------------------------------------------------------------

def _main(rank, S, store_path, out_dir, task, kw):
    torch.set_num_threads(1)
    result_path = pathlib.Path(out_dir) / f"{task}_{rank}.pt"
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store_path, S),
                                rank=rank, world_size=S)
        try:
            result = {"ok": TASKS[task](rank, S, **kw)}
        finally:
            dist.destroy_process_group()
    except Exception:   # noqa: BLE001 - reported to the parent
        result = {"error": traceback.format_exc()}
    torch.save(result, result_path)


def run_ranks(task, S, tmp_path, timeout=TIMEOUT_S, **kw):
    """Run ``TASKS[task]`` on S spawned ``gloo`` ranks; each rank's result
    in rank order.  Raises AssertionError on a rank's error, a non-zero
    exit or the timeout (the stragglers are killed)."""
    ctx = torch.multiprocessing.get_context("spawn")
    tmp_path = pathlib.Path(tmp_path)
    store = tmp_path / f"{task}_{S}.store"
    if store.exists():
        os.remove(store)
    procs = [ctx.Process(target=_main, args=(r, S, str(store), str(tmp_path), task, kw))
             for r in range(S)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in hung:
        procs[r].kill()
        procs[r].join()
    assert not hung, f"{task}: ranks {hung} did not finish within {timeout} s"
    results = []
    for r, p in enumerate(procs):
        path = tmp_path / f"{task}_{r}.pt"
        assert p.exitcode == 0 and path.exists(), f"{task}: rank {r} exited {p.exitcode}"
        res = torch.load(path, weights_only=False)
        assert "ok" in res, f"{task}: rank {r} failed:\n{res['error']}"
        results.append(res["ok"])
    return results


def same_on_every_rank(results) -> bool:
    """Every rank's result bit-identical to rank 0's (nested dicts and
    lists of numpy arrays)."""
    def eq(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(eq(a[k], b[k]) for k in a)
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(eq(x, y) for x, y in zip(a, b))
        if isinstance(a, np.ndarray):
            return (a.dtype == b.dtype and a.shape == b.shape
                    and a.tobytes() == b.tobytes())
        return a == b
    return all(eq(results[0], r) for r in results[1:])
