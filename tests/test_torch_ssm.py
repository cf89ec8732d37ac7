"""Port parity of the Mamba mixers: ``repro_torch.models.ssm.mamba_fwd``
against ``repro.models.ssm.mamba_fwd`` on the same numpy weights (the
reference's ``init_mamba``, carried into a ``Mamba`` module) and inputs,
for the reduced Falcon-Mamba-7B (Mamba-1: d_model 256, d_inner 512,
state 16, dt rank 256) and Zamba2-1.2B (Mamba-2: 16 heads of 32, state
16), f32, within rtol = atol = 1e-4 (``tests/test_torch_serve.py``).

Stateless, stateful at S = 1 (a decode step) and stateful at S > 1 (the
reference folds the initial state in by ``cumprod(decay) * h0``), each
with the new conv ring and ``h`` compared; the chunked scan over more than
one chunk (``SCAN_CHUNK`` positions each; lowered to 16 so that 40
positions take three) against the reference's one associative scan; the
causal convolution's ring; the init's shapes.  No file of the JAX package
changes."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS
from repro.models import ssm as jssm
from repro_torch.configs import registry as tregistry
from repro_torch.models import ssm as tssm

TOL = 1e-4
NAMES = ["falcon-mamba-7b", "zamba2-1.2b"]


def _configs(name):
    return ARCHS[name].reduced(), tregistry.get_config(name).reduced()


@functools.lru_cache(maxsize=None)
def _weights(name, seed=3):
    jcfg, _ = _configs(name)
    return jax.tree.map(np.asarray, jssm.init_mamba(jcfg, jax.random.PRNGKey(seed)))


def _module(name):
    _, tcfg = _configs(name)
    mod = tssm.Mamba(tcfg, torch.Generator().manual_seed(0), "cpu")
    mod.load_state_dict({k: torch.from_numpy(v.copy()) for k, v in _weights(name).items()},
                        strict=True)
    return mod


@functools.lru_cache(maxsize=None)
def _jax_fwd(name):
    jcfg, _ = _configs(name)
    return jax.jit(functools.partial(jssm.mamba_fwd, jcfg))


def _x(cfg, B, S, seed=0):
    return np.random.default_rng(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _state(cfg, B, seed):
    """A nonzero state of the reference's shapes (``init_ssm_state``)."""
    rng = np.random.default_rng(seed)
    z = jssm.init_ssm_state(cfg, B, jnp.float32)
    return {k: (0.5 * rng.standard_normal(v.shape)).astype(np.float32) for k, v in z.items()}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


def _run(name, S, stateful, seed=0):
    jcfg, tcfg = _configs(name)
    x = _x(tcfg, 2, S, seed)
    st = _state(jcfg, 2, seed + 10) if stateful else None
    want, wst = _jax_fwd(name)(_weights(name), jnp.asarray(x),
                               None if st is None else jax.tree.map(jnp.asarray, st))
    with torch.no_grad():
        got, gst = tssm.mamba_fwd(tcfg, _module(name), torch.as_tensor(x),
                                  None if st is None else {k: torch.as_tensor(v)
                                                           for k, v in st.items()})
    assert got.shape == (2, S, tcfg.d_model) and got.dtype == torch.float32
    _close(got, want)
    if stateful:
        assert set(gst) == set(wst) == {"conv", "h"}
        for k in ("conv", "h"):
            assert tuple(gst[k].shape) == wst[k].shape, k
            _close(gst[k], wst[k])
    else:
        assert gst is None and wst is None
    return got, gst


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("S,stateful", [(40, False), (1, True), (40, True)],
                         ids=["stateless", "decode-step", "stateful-S40"])
def test_mamba_fwd_matches_reference(name, S, stateful, monkeypatch):
    """40 positions in chunks of 16 (three chunks, the last ragged): the
    carry across chunks is the reference's fold."""
    monkeypatch.setattr(tssm, "SCAN_CHUNK", 16)
    _run(name, S, stateful)


@pytest.mark.parametrize("name", NAMES)
def test_chunked_scan_at_the_default_chunk(name):
    """300 positions at the default ``SCAN_CHUNK`` (128): two whole chunks
    and a ragged one, stateless and stateful."""
    assert tssm.SCAN_CHUNK == 128
    for stateful in (False, True):
        _run(name, 300, stateful, seed=4)


def test_assoc_scan_matches_the_recurrence():
    """The log-depth scan and its running decay product against the plain
    loop h_t = d_t h_{t-1} + x_t, at a length that is no power of two, with
    a decay that broadcasts (Mamba-2's one scalar a head)."""
    g = torch.Generator().manual_seed(0)
    decay = torch.rand((2, 37, 3, 1), generator=g, dtype=torch.float64)
    inp = torch.randn((2, 37, 3, 5), generator=g, dtype=torch.float64)
    h, cum = tssm._assoc_scan(decay, inp)
    want, run, prod = [], torch.zeros((2, 3, 5), dtype=torch.float64), torch.ones(
        (2, 3, 1), dtype=torch.float64)
    for t in range(37):
        run = decay[:, t] * run + inp[:, t]
        prod = prod * decay[:, t]
        want.append(run)
        assert torch.allclose(cum[:, t], prod, rtol=1e-12)
    assert torch.allclose(h, torch.stack(want, 1), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_stepped_states_equal_one_stateful_call(name, monkeypatch):
    """Twelve stateful calls of one position each leave the state that one
    stateful call over the twelve leaves, and give its outputs."""
    monkeypatch.setattr(tssm, "SCAN_CHUNK", 5)
    jcfg, tcfg = _configs(name)
    mod = _module(name)
    x = torch.as_tensor(_x(tcfg, 2, 12, seed=7))
    st0 = {k: torch.as_tensor(v) for k, v in _state(jcfg, 2, 8).items()}
    with torch.no_grad():
        whole, st_w = tssm.mamba_fwd(tcfg, mod, x, st0)
        st, outs = st0, []
        for t in range(12):
            o, st = tssm.mamba_fwd(tcfg, mod, x[:, t:t + 1], st)
            outs.append(o)
    _close(torch.cat(outs, 1), whole)
    for k in ("conv", "h"):
        _close(st[k], st_w[k])


@pytest.mark.parametrize("name", NAMES)
def test_causal_conv_ring_matches_reference(name):
    jcfg, tcfg = _configs(name)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 6, tcfg.d_inner_)).astype(np.float32)
    ring = rng.standard_normal((2, tcfg.ssm_conv - 1, tcfg.d_inner_)).astype(np.float32)
    w = jax.tree.map(jnp.asarray, _weights(name))
    mod = _module(name)
    for state in (None, ring):
        want, wnew = jssm._causal_conv(jcfg, w, jnp.asarray(x),
                                       None if state is None else jnp.asarray(state))
        got, gnew = tssm._causal_conv(tcfg, mod, torch.as_tensor(x),
                                      None if state is None else torch.as_tensor(state))
        _close(got.detach(), want)
        if state is None:
            assert gnew is None and wnew is None
        else:
            assert gnew.shape == (2, tcfg.ssm_conv - 1, tcfg.d_inner_)
            _close(gnew, wnew)


@pytest.mark.parametrize("name", NAMES + ["zamba2-1.2b-full"])
def test_init_shapes_and_state_layout(name):
    """The port's own init (its values need not be the reference's): every
    leaf of the reference's shape and type, the deterministic leaves equal
    to the reference's (``conv_b``, ``D``, ``A_log``, ``dt_bias`` and
    ``gnorm`` of Mamba-2), and the decode state's layout: ``conv`` (B, kw -
    1, di) in the activations' type, ``h`` f32."""
    base = name.removesuffix("-full")
    jcfg, tcfg = _configs(base)
    if name.endswith("-full"):   # Zamba2's own head count: 64 heads of 64
        jcfg, tcfg = (dataclasses.replace(c, d_model=128, d_inner=4096, n_layers=2)
                      for c in (ARCHS[base], tregistry.get_config(base)))
    want = jax.eval_shape(lambda: jssm.init_mamba(jcfg, jax.random.PRNGKey(0)))
    mod = tssm.Mamba(tcfg, torch.Generator().manual_seed(0), "cpu")
    got = dict(mod.named_parameters())
    assert sorted(got) == sorted(want)
    ref = jax.tree.map(np.asarray, jssm.init_mamba(jcfg, jax.random.PRNGKey(0)))
    for k, w in want.items():
        assert tuple(got[k].shape) == w.shape and got[k].dtype == torch.float32, k
        assert bool(torch.isfinite(got[k]).all()), k
    fixed = ["conv_b", "D", "A_log"] + (["dt_bias", "gnorm"] if jcfg.ssm_variant == "mamba2"
                                        else [])
    for k in fixed:
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-6, atol=1e-7, err_msg=k)
    if jcfg.ssm_variant == "mamba1":   # the inverse softplus of a step in [1e-3, 0.1]
        step = torch.nn.functional.softplus(got["dt_bias"])
        assert float(step.min()) >= 1e-3 * (1 - 1e-5) and float(step.max()) <= 0.1 * (1 + 1e-5)
    shapes = jax.eval_shape(lambda: jssm.init_ssm_state(jcfg, 3, jnp.bfloat16))
    st = tssm.init_ssm_state(tcfg, 3, torch.bfloat16, "cpu", lead=(2,))
    for k in ("conv", "h"):
        assert tuple(st[k].shape) == (2,) + shapes[k].shape, k
        assert str(st[k].dtype) == f"torch.{shapes[k].dtype.name}", k
        assert tssm.state_shapes(tcfg, 3)[k] == shapes[k].shape
