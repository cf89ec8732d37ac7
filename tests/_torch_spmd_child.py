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
        return x.detach().cpu().numpy()
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


TASKS = {"round": task_round, "scan": task_scan, "engine": task_engine,
         "group_size": task_group_size, "flat": task_flat}


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
