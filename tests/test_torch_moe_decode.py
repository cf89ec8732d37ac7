"""Port parity of the MoE family's decode (DeepSeek-V2-Lite with MLA's
latent ``ckv`` / ``krope`` ring and its prefix block's cache, Moonlight,
Arctic, also with ``param_dtype`` bf16) in the reduced configs, against
the reference's jitted ``decode_step`` on the same weights and tokens
(``tests/test_torch_moe_models.py``'s helpers): logits and every cache
tensor within rtol = atol = 1e-4 over 3 steps, decode through a prompt
against one prefill, and the latent ring's wrap.  Split from
``tests/test_torch_moe_models.py`` so that ``--dist loadfile`` spreads the
two.  No file of the JAX package changes."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.core import flatten as F
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.train import serve as tserve

from test_torch_moe_models import NAMES, _close, _models, _tokens


# ---------------------------------------------------------------------------
# decode


@functools.lru_cache(maxsize=None)
def _jax_decode_step(jcfg):
    return jax.jit(functools.partial(JM.decode_step, jcfg))


def _jax_steps(jcfg, jparams, B, total, toks):
    cache = JM.init_cache(jcfg, B, total)
    step = _jax_decode_step(jcfg)
    out = []
    for t in toks:
        logits, cache = step(jparams, cache, jnp.asarray(t))
        out.append(np.asarray(logits))
    return out, cache


def _port_steps(tcfg, model, B, total, toks):
    cache = TM.init_cache(tcfg, B, total, device="cpu")
    step = tserve.build_decode_step(tcfg, device="cpu")
    out = []
    for t in toks:
        logits, cache = step(model, cache, torch.as_tensor(t))
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("name", NAMES)
def test_decode_steps_match_decode_step(name):
    """Three decode steps: logits and every cache tensor (MLA: the latent
    ``ckv`` (B, capacity, r) and ``krope`` (B, capacity, rd); the prefix
    block's own cache) against the reference's ``decode_step``."""
    jcfg, jparams, tcfg, model = _models(name)
    B, total = 2, 16
    toks = [_tokens(tcfg, B, 1, seed=s) for s in range(3)]
    want, jcache = _jax_steps(jcfg, jparams, B, total, toks)
    got, tcache = _port_steps(tcfg, model, B, total, toks)
    for g, w in zip(got, want):
        assert g.shape == (B, 1, tcfg.vocab_size)
        _close(g, w)
    assert tcache["idx"] == int(jcache["idx"]) == 3
    assert set(tcache) == set(jcache)
    if tcfg.use_mla:
        assert tcache["layers"]["ckv"].shape == (1, B, total, tcfg.kv_lora_rank)
        assert tcache["layers"]["krope"].shape == (1, B, total, tcfg.qk_rope_dim)
    leaves = jax.tree_util.tree_flatten_with_path({k: v for k, v in jcache.items()
                                                  if k != "idx"})[0]
    ported = F.tree_leaves({k: v for k, v in tcache.items() if k != "idx"})
    assert len(leaves) == len(ported)
    for (path, w), g in zip(leaves, ported):
        assert tuple(g.shape) == w.shape, path
        _close(g, w)


@pytest.mark.parametrize("name", NAMES)
def test_decode_through_a_prompt_matches_prefill(name):
    """Stepping one token at a time through a prompt (MLA: the absorbed
    form on the latent cache) gives, at every position, the logits of one
    prefill of the same tokens (MLA: materialised K and V).  The prefill
    runs at ``capacity_factor = E / top_k`` (capacity S: no pick can
    drop), as a decode step does (capacity 1, one token's distinct
    experts); at the config's factor a prefill's per-row capacity drops
    picks, in the reference as here, and its logits are other ones."""
    _, _, tcfg, model = _models(name)
    tok = _tokens(tcfg, 2, 12, seed=5)
    no_drop = dataclasses.replace(tcfg, capacity_factor=tcfg.n_experts / tcfg.top_k)
    assert tlayers.moe_capacity(no_drop, 12) == 12
    prefill = tserve.build_prefill(no_drop, device="cpu")(model,
                                                          {"tokens": torch.as_tensor(tok)})
    stepped, cache = _port_steps(tcfg, model, 2, 12, [tok[:, i:i + 1] for i in range(12)])
    _close(torch.cat(stepped, dim=1), prefill)
    assert cache["idx"] == 12


def test_mla_ring_wraps_like_the_reference():
    """A latent ring of 8 slots (``sliding_window`` 8) over 12 steps: the
    reference's masks before and after the wrap."""
    jcfg, jparams, tcfg, model = _models("deepseek-v2-lite-16b", sliding_window=8)
    toks = [_tokens(tcfg, 2, 1, seed=20 + s) for s in range(12)]
    want, jcache = _jax_steps(jcfg, jparams, 2, 32, toks)
    got, tcache = _port_steps(tcfg, model, 2, 32, toks)
    assert tcache["layers"]["ckv"].shape[2] == 8
    for g, w in zip(got, want):
        _close(g, w)
    _close(tcache["layers"]["ckv"], jcache["layers"]["ckv"])
