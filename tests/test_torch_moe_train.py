"""Port parity of the loss, its backward and the robust-DP trainer on the
MoE family (DeepSeek-V2-Lite: MLA + MoE with one dense prefix block;
Moonlight: GQA + MoE), against the JAX package on the same numpy weights
(carried by ``params_from_jax``) and tokens.
``jax.value_and_grad(loss_fn)`` on the reduced configs: loss, aux and ce
within rtol 1e-5, every gradient leaf within rtol 1e-4 / atol 1e-6
(``tests/test_torch_loss.py``); 3-step stacked, flat and gspmd
trajectories of a narrowed DeepSeek-V2-Lite against the reference's
composed step (``tests/test_torch_trainer.py``'s harness).  No file of the
JAX package changes."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.core import flatten as F
from repro_torch.models import model as TM
from repro_torch.train import trainer as tr

from test_torch_moe_models import _configs, _tokens

# the trajectory's width: the reduced DeepSeek-V2-Lite narrowed as
# tests/test_torch_trainer.py narrows Qwen (MLA rank 16, rope 8)
SMALL = dict(d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=128,
             kv_lora_rank=16, qk_rope_dim=8)


@functools.lru_cache(maxsize=None)
def _eager_tree(name):
    """The reference's parameters of the reduced config, made once a module
    by the eager init.  Not the jitted one of ``_reference``: its other bits
    put one of Moonlight's embedding-gradient values 7.4e-7 past this
    test's atol (the two packages' sums over the positions in other
    orders)."""
    jcfg, _ = _configs(name)
    return jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "moonshot-v1-16b-a3b"])
def test_loss_and_grad_match_reference(name, chunk):
    """``jax.value_and_grad(loss_fn)`` on the reduced model: the loss (ce +
    aux), its aux and ce, and every gradient leaf, the experts' stacked
    leaves, the router and the prefix block's included."""
    jcfg, tcfg = _configs(name, loss_chunk=chunk)
    tree = _eager_tree(name)
    tokens = _tokens(tcfg, 2, 17, seed=2)
    (lj, mj), gj = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, {"tokens": tokens}), has_aux=True))(tree)
    model = TM.params_from_jax(tree, tcfg, device="cpu")
    F.layout_flat(model)
    lt, gt = tr.loss_and_grad(tcfg, model, {"tokens": torch.as_tensor(tokens).long()})
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    with torch.no_grad():
        _, mt = TM.loss_fn(tcfg, model, {"tokens": torch.as_tensor(tokens)})
    assert float(mj["aux"]) > 0
    for k in ("aux", "ce"):
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-5, err_msg=k)
    leaves = F.tree_leaves(F.unravel_like(gt, model))
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(gj)[0], leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
    router = F.module_tree(model)["layers"]["ffn"]["router"]
    assert float(F.unravel_like(gt, model)["layers"]["ffn"]["router"].abs().max()) > 0
    assert router.shape == (1, tcfg.d_model, tcfg.n_experts)


@pytest.mark.parametrize("layout", ["stacked", "flat", "gspmd"])
def test_robust_dp_matches_reference(layout, monkeypatch):
    """Three steps of the trainer on the reduced DeepSeek-V2-Lite at
    ``SMALL`` width, K=4, against the reference's composed step
    (``tests/test_torch_trainer.py``): robust_dp stacked on the fused
    backend (its plain version here) and flat (the count sketch's bits
    the reference's), one candidate under IPM-100, and the gspmd mean:
    loss, weights, masks and every parameter after each step; the loss is
    ce + aux.  The reference's pieces run under ``jax.jit``
    (``ReferenceStep``)."""
    import functools

    from repro_torch.distributed import robust_allreduce as tra
    from _torch_fixtures import reference_sketch_hash
    from test_torch_trainer import _hold_trajectory, _tcs

    jcfg, cfg = _configs("deepseek-v2-lite-16b", **SMALL)
    if layout == "gspmd":
        jtc, tc = _tcs(4, mode="gspmd", agg=dict(method="mean"))
    else:
        monkeypatch.setattr(tra, "sketch_hash", functools.lru_cache(maxsize=None)(
            reference_sketch_hash))
        agg = dict(method="wfagg", layout=layout, backend="reference", chunk_size=4096,
                   sketch_dim=256)
        jtc, tc = _tcs(4, attack="ipm_100", n_malicious=1, agg=agg)
        tc = dataclasses.replace(tc, agg=dataclasses.replace(tc.agg, backend="fused"))
    st, m = _hold_trajectory(jcfg, cfg, jtc, tc, 4)
    if layout != "gspmd":
        assert float(m["weights"][2]) == 0.0
    assert isinstance(F.module_tree(st.params)["prefix_layers"], list)
