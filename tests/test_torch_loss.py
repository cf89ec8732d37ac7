"""Port parity of the LM loss and its backward: ``repro_torch.models.
model.loss_fn`` (through the trainer's ``loss_and_grad``: the gradient as
one vector in ravel order) against ``jax.value_and_grad(repro.models.
model.loss_fn)`` on the reduced Qwen1.5-0.5B (2 layers), on the same numpy
weights and tokens: loss within rtol 1e-5, gradients within rtol 1e-4 /
atol 1e-6, for the plain cross-entropy and the chunked one (a chunk that
divides S - 1, one that does not, and one above S - 1: loss 0 and
gradient 0, the reference's truncation).  Also the ``TokenStream``
determinism mirror and the refusal of ``flash=True`` under autograd."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs.registry import get_config as jget_config
from repro.models import model as JM
from repro_torch.configs.registry import get_config
from repro_torch.core import flatten as F
from repro_torch.data.synthetic import TokenStream
from repro_torch.models import model as TM
from repro_torch.train import trainer as tr

S = 33


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("qwen1.5-0.5b").reduced()
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    return jcfg, tree, tokens


@pytest.mark.parametrize("chunk", [0, 8, 12, 40])
def test_loss_and_grad_match_reference(setup, chunk):
    jcfg, tree, tokens = setup
    jcfg = dataclasses.replace(jcfg, loss_chunk=chunk)
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(), loss_chunk=chunk)
    (lj, aux), gj = jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, {"tokens": tokens}), has_aux=True)(tree)
    model = TM.params_from_jax(tree, cfg, device="cpu")
    F.layout_flat(model)
    lt, gt = tr.loss_and_grad(cfg, model, {"tokens": torch.as_tensor(tokens).long()})
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-5)
    want = np.asarray(ravel_pytree(gj)[0])
    np.testing.assert_allclose(gt.numpy(), want, rtol=1e-4, atol=1e-6)
    if chunk > S - 1:
        assert float(lt) == float(lj) == 0.0
        assert not gt.any() and not want.any()
    else:
        assert float(lt) > 0.0 and gt.abs().max() > 0
    # the loss alone, no gradient taken
    with torch.no_grad():
        l2, parts = TM.loss_fn(cfg, model, {"tokens": torch.as_tensor(tokens)})
    assert float(l2) == float(lt) and float(parts["aux"]) == 0.0
    assert np.isclose(float(parts["ce"]), float(aux["ce"]), rtol=1e-5)


def test_flash_refused_in_training(setup):
    _, tree, tokens = setup
    cfg = get_config("qwen1.5-0.5b").reduced()
    model = TM.params_from_jax(tree, cfg, device="cpu")
    batch = {"tokens": torch.as_tensor(tokens)}
    with torch.enable_grad(), pytest.raises(NotImplementedError, match="no backward"):
        TM.loss_fn(cfg, model, batch, flash=True)
    with torch.no_grad():       # the forward alone may take the flash route
        assert torch.isfinite(TM.loss_fn(cfg, model, batch, flash=True)[0])


def test_token_stream_deterministic():
    """tests/test_infra.py::test_token_stream_deterministic."""
    s = TokenStream(vocab_size=256, seq_len=16, batch_size=4, seed=3)
    b1, b2 = s.batch(5), s.batch(5)
    assert torch.equal(b1["tokens"], b2["tokens"])
    b3 = s.batch(6)
    assert not torch.equal(b1["tokens"], b3["tokens"])
    assert int(b1["tokens"].max()) < 256 and b1["tokens"].shape == (4, 16)
    # the chain: every token after the first is one of its predecessor's 8
    succ = s._chain()
    t = b1["tokens"]
    assert all(int(t[b, i + 1]) in succ[int(t[b, i])].tolist()
               for b in range(4) for i in range(15))
