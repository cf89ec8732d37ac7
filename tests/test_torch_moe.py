"""Port parity of the MoE FFN: ``repro_torch.models.layers.moe_fwd`` (its
router ``moe_route``, capacity ``moe_capacity`` and slot order
``moe_dispatch``) against ``repro.models.layers.moe_fwd`` on the same
numpy weights (the reference's ``init_moe``, carried into an ``MoE``
module) and inputs, for the reduced DeepSeek-V2-Lite (1 shared expert),
Moonlight (1 shared expert) and Arctic (the dense residual MLP): 4
experts, top-2, d_model 256, f32.

The routing is compared bit for bit: each token's experts in the order of
``jax.lax.top_k`` and the ``within`` mask of the reference's dispatch
(its ``one_hot`` / ``cumsum`` slot count, computed here with the
reference's own jnp operations), so the same picks drop.  ``aux`` agrees
within ``TOL`` = 1e-4 (``tests/test_torch_serve.py``), ``out`` within
rtol ``TOL`` and an atol of ``TOL`` times its rms: the reference's expert
init (fan-in 1/sqrt(E) on a stacked leaf) makes ``out`` reach ~700 on
unit inputs, where f32 sums in the two packages' orders differ by ~1e-4
absolutely, so an element that cancels to ~0.3 differs by 7e-4
relatively.
Cases: the config's capacity factor, 0.5 (so that picks drop), tied
router probabilities (equal router columns: ``jax.lax.top_k`` takes the
lower index first, and so does the port's stable sort), and S = 1 (a
decode step, capacity 1)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.models import layers as jlayers
from repro_torch.configs import registry as tregistry
from repro_torch.models import layers as tlayers

TOL = 1e-4
NAMES = ["deepseek-v2-lite-16b", "moonshot-v1-16b-a3b", "arctic-480b"]


def _flat(node, prefix=""):
    out = {}
    for k, v in node.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.asarray(v).copy())
    return out


def _setup(name, tie=False, **over):
    jcfg = dataclasses.replace(ARCHS[name].reduced(), **over)
    tcfg = dataclasses.replace(tregistry.get_config(name).reduced(), **over)
    jp = jax.tree.map(np.asarray, jlayers.init_moe(jcfg, jax.random.PRNGKey(3)))
    if tie:             # experts 1 and 3 copy the router columns of 0 and 2
        r = jp["router"].copy()
        r[:, 1], r[:, 3] = r[:, 0], r[:, 2]
        jp["router"] = r
    mod = tlayers.MoE(tcfg, torch.Generator().manual_seed(0), "cpu")
    mod.load_state_dict(_flat(jp), strict=True)
    return jcfg, jp, tcfg, mod


def _x(cfg, B, S, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _reference_routing(jcfg, jp, x):
    """The reference's top-k and within mask, with its own operations
    (``moe_fwd``'s router and ``dispatch_row``)."""
    E, k = jcfg.n_experts, jcfg.top_k
    probs = jax.nn.softmax((jnp.asarray(x) @ jp["router"]).astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    S = x.shape[1]
    capacity = max(1, int(jcfg.capacity_factor * k * S / E))

    def row(er):
        e_flat = er.T.reshape(-1)
        onehot = jax.nn.one_hot(e_flat, E, dtype=jnp.int32)
        pos = jnp.cumsum(onehot, axis=0) - onehot
        pos_flat = jnp.take_along_axis(pos, e_flat[:, None], axis=1)[:, 0]
        return pos_flat < capacity

    return np.asarray(probs), np.asarray(idx), np.asarray(jax.vmap(row)(idx)), capacity


CASES = [(name, dict(), False, 24) for name in NAMES] + [
    ("deepseek-v2-lite-16b", dict(capacity_factor=0.5), False, 24),
    ("arctic-480b", dict(capacity_factor=0.5), False, 24),
    ("moonshot-v1-16b-a3b", dict(), True, 24),
    ("arctic-480b", dict(capacity_factor=0.5), True, 24),
    ("deepseek-v2-lite-16b", dict(), False, 1),
    ("arctic-480b", dict(), False, 1),
]


@pytest.mark.parametrize("name,over,tie,S", CASES,
                         ids=[f"{c[0]}-{'cf0.5' if c[1] else 'cf'}{'-tied' if c[2] else ''}"
                              f"-S{c[3]}" for c in CASES])
def test_moe_fwd_matches_reference(name, over, tie, S):
    jcfg, jp, tcfg, mod = _setup(name, tie, **over)
    B = 3
    x = _x(tcfg, B, S, seed=S)
    probs, idx, within, capacity = _reference_routing(jcfg, jp, x)
    xt = torch.as_tensor(x)
    tprobs, _, tidx = tlayers.moe_route(tcfg, mod, xt)
    assert tlayers.moe_capacity(tcfg, S) == capacity
    if S == 1:
        assert capacity == 1
    assert np.array_equal(tidx.numpy(), idx), "expert choice"
    _, _, twithin = tlayers.moe_dispatch(tidx, tcfg.n_experts, capacity)
    assert np.array_equal(twithin.numpy(), within), "within mask"
    if tie:
        # the ties are real in both packages, and both took the lower index
        assert np.array_equal(probs[..., 0], probs[..., 1])
        assert torch.equal(tprobs[..., 0], tprobs[..., 1])
        assert not np.any((idx[..., 0] == 1) & (idx[..., 1] == 0))
    if over.get("capacity_factor") == 0.5:
        assert not within.all(), "the case must drop picks"
    want, waux = jlayers.moe_fwd(jcfg, jp, jnp.asarray(x))
    got, gaux = tlayers.moe_fwd(tcfg, mod, xt)
    assert got.shape == (B, S, tcfg.d_model) and got.dtype == torch.float32
    _close_scaled(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(float(gaux), float(waux), rtol=TOL, atol=TOL)


def _close_scaled(got, want):
    scale = float(np.sqrt(np.mean(np.square(want, dtype=np.float64))))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


def test_dropped_picks_contribute_nothing():
    """A pick past its expert's capacity adds nothing to its token: the
    output equals the gate-weighted sum over the kept picks alone,
    computed expert by expert."""
    _, _, tcfg, mod = _setup("deepseek-v2-lite-16b", capacity_factor=0.5)
    x = torch.as_tensor(_x(tcfg, 2, 16, seed=4))
    out, _ = tlayers.moe_fwd(tcfg, mod, x)
    _, gate, idx = tlayers.moe_route(tcfg, mod, x)
    gate = gate / gate.sum(-1, keepdim=True)
    C = tlayers.moe_capacity(tcfg, 16)
    _, _, within = tlayers.moe_dispatch(idx, tcfg.n_experts, C)
    within = within.reshape(2, tcfg.top_k, 16).transpose(1, 2)            # (B, S, k)
    want = tlayers.mlp_fwd(mod.shared, x)
    for b in range(2):
        for s in range(16):
            for j in range(tcfg.top_k):
                if within[b, s, j]:
                    e = int(idx[b, s, j])
                    xe = x[b, s]
                    h = torch.nn.functional.silu(xe @ mod.w_gate[e]) * (xe @ mod.w_up[e])
                    want[b, s] += gate[b, s, j] * (h @ mod.w_down[e])
    assert not within.all()
    _close_scaled(out.numpy(), want.numpy())


def test_moe_init_shapes_and_bf16_parameters():
    """The port's own init: the reference's shapes and fan-in (1/sqrt(E)
    for a stacked expert leaf, 0.02 for the router); with ``param_dtype``
    bf16 every leaf is bf16 and the forward runs in the activation dtype."""
    cfg = tregistry.get_config("arctic-480b").reduced()
    mod = tlayers.MoE(cfg, torch.Generator().manual_seed(0), "cpu")
    E, d, ff = cfg.n_experts, cfg.d_model, cfg.d_ff
    assert mod.w_gate.shape == (E, d, ff) and mod.w_down.shape == (E, ff, d)
    assert mod.dense_residual.w_up.shape == (d, cfg.dense_residual_ff)
    assert float(mod.w_gate.abs().max()) <= 2.0 / E ** 0.5 + 1e-6
    assert float(mod.router.abs().max()) <= 0.04 + 1e-6
    bf = dataclasses.replace(cfg, param_dtype="bfloat16")
    mb = tlayers.MoE(bf, torch.Generator().manual_seed(0), "cpu")
    assert {p.dtype for p in mb.parameters()} == {torch.bfloat16}
    # drawn in f32 and cast: the same draws as the f32 init, rounded
    assert torch.equal(mb.w_gate, mod.w_gate.to(torch.bfloat16))
    out, aux = tlayers.moe_fwd(bf, mb, torch.randn(2, 5, d))
    assert out.dtype == torch.float32 and torch.isfinite(out).all() and aux.dtype == torch.float32
