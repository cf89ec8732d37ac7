"""Port parity of the loss, its backward and the robust-DP trainer on the
SSM and hybrid families (Falcon-Mamba-7B and Zamba2-1.2B reduced, Zamba2
at 4 layers, two groups), against the JAX package on the same numpy
weights (carried by ``params_from_jax``) and tokens.
``jax.value_and_grad(loss_fn)``: the loss within rtol 1e-5, every
gradient leaf within rtol 1e-4 and an atol of 1e-4 times the leaf's
largest magnitude (at most 1e-4), through the scan's backward over more
than one chunk: the embedding's gradient sums each token's rows over every
position and, in the hybrid, over the two groups' ``h0`` as well, so f32
sums in the two packages' orders differ by up to 2.1e-6 of the leaf's
largest value (1.4) where the sum cancels to ~1e-5; every leaf here is
within 4.2e-6 of its largest value.  The ported remat
(``torch.utils.checkpoint`` around the Mamba layer and the hybrid's group,
the reference's ``jax.checkpoint``) gives bit-equal gradients; a 3-step
stacked robust-DP trajectory of a narrowed Zamba2 against the
reference's composed step (``tests/test_torch_trainer.py``'s harness);
the launcher with ``--arch zamba2-1.2b``.  No file of the JAX package
changes."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.core import flatten as F
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm
from repro_torch.train import trainer as tr

from test_torch_ssm_models import _configs, _reference, _tokens

# the trajectory's width: the reduced Zamba2 at two groups, narrowed as
# tests/test_torch_trainer.py narrows Qwen (4 Mamba-2 heads of 32)
SMALL = dict(d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=128,
             d_inner=128)


def _grad(tcfg, tree, tokens):
    model = TM.params_from_jax(tree, tcfg, device="cpu")
    F.layout_flat(model)
    loss, g = tr.loss_and_grad(tcfg, model, {"tokens": torch.as_tensor(tokens).long()})
    return model, loss, g


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "zamba2-1.2b-g2"])
def test_loss_and_grad_match_reference(name, monkeypatch):
    """The full-logits loss (both configs have ``loss_chunk`` 0) and every
    gradient leaf, the scan's in chunks of 8 over 20 positions."""
    monkeypatch.setattr(tssm, "SCAN_CHUNK", 8)
    jcfg, tcfg = _configs(name)
    tree = _reference(jcfg, 0)[1]
    tokens = _tokens(tcfg, 2, 21, seed=2)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, {"tokens": tokens}), has_aux=True))(tree)
    model, lt, gt = _grad(tcfg, tree, tokens)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    with torch.no_grad():
        _, mt = TM.loss_fn(tcfg, model, {"tokens": torch.as_tensor(tokens)})
    for k in ("aux", "ce"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5, err_msg=k)
    leaves = F.tree_leaves(F.unravel_like(gt, model))
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(gj)[0], leaves):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * min(1.0, float(np.abs(w).max())),
                                   err_msg=jax.tree_util.keystr(path))
    grads = F.unravel_like(gt, model)
    assert float(grads["layers"]["mixer"]["A_log"].abs().max()) > 0
    if "shared_attn" in grads:
        assert float(grads["shared_attn"]["in_proj"].abs().max()) > 0


@pytest.mark.parametrize("name", ["falcon-mamba-7b", "zamba2-1.2b-g2"])
def test_remat_gradients_are_bit_equal(name, monkeypatch):
    """The same loss and gradient, bit for bit, with ``remat`` on (each Mamba
    layer and each hybrid group recomputed in the backward) and off; with
    it on, the checkpoints do run (counted)."""
    monkeypatch.setattr(tssm, "SCAN_CHUNK", 8)
    jcfg, tcfg = _configs(name)
    tree = _reference(jcfg, 0)[1]
    tokens = _tokens(tcfg, 2, 21, seed=3)
    runs = {}
    calls = []
    real = TM.checkpoint
    monkeypatch.setattr(TM, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    for remat in (False, True):
        cfg = dataclasses.replace(tcfg, remat=remat)
        _, loss, g = _grad(cfg, tree, tokens)
        runs[remat] = (loss, g)
    n_groups = tcfg.n_layers // tcfg.shared_attn_every if tcfg.family == "hybrid" else 0
    # per group: the group's checkpoint and, in its forward and its
    # recompute, each Mamba layer's; an SSM model: one per layer
    want = n_groups * (1 + 2 * tcfg.shared_attn_every) if n_groups else tcfg.n_layers
    assert len(calls) == want
    assert torch.equal(runs[True][0], runs[False][0])
    assert runs[True][1].numpy().tobytes() == runs[False][1].numpy().tobytes()


def test_robust_dp_matches_reference():
    """Three steps of the trainer on Zamba2 at two groups and ``SMALL``
    width, K=4, against the reference's composed step: robust_dp stacked
    on the fused backend (its plain version here), one candidate under
    IPM-100: loss, weights, masks and every parameter after each step (the
    gspmd and flat layouts share everything but the all-reduce with the
    dense and MoE trajectories, ``tests/test_torch_{trainer,moe_train}.py``).  The
    reference's init and step pieces run under ``jax.jit``
    (``ReferenceStep``)."""
    from test_torch_trainer import _hold_trajectory, _tcs

    jcfg, cfg = _configs("zamba2-1.2b-g2", **SMALL)
    agg = dict(method="wfagg", layout="stacked", backend="reference")
    jtc, tc = _tcs(4, attack="ipm_100", n_malicious=1, agg=agg)
    tc = dataclasses.replace(tc, agg=dataclasses.replace(tc.agg, backend="fused"))
    st, m = _hold_trajectory(jcfg, cfg, jtc, tc, 4)
    assert float(m["weights"][2]) == 0.0
    assert "shared_attn" in F.module_tree(st.params)


def test_launcher_runs_the_hybrid(capsys):
    from repro_torch.launch import train as T
    T.main(["--arch", "zamba2-1.2b", "--reduced", "--n-layers", "4", "--candidates", "4",
            "--steps", "2", "--seq-len", "16", "--global-batch", "4", "--log-every", "1",
            "--agg-backend", "fused"], device="cpu")
    out = capsys.readouterr().out
    assert "arch=zamba2-1.2b-smoke" in out and "done: 2 steps" in out
