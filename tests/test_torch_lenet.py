"""Port parity of the local models: weights carried across from the JAX
package (``params_from_jax``) flatten to exactly ``ravel_pytree``'s
vector, and LeNet-5 / MLP logits and cross-entropy gradients match the
reference on the same images within 1e-5 (float32 convolutions and
matmuls summed in another order)."""
import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core import metrics as jmet
from repro.data.synthetic import SyntheticImages as JImages
from repro.models import lenet as jlenet
from repro_torch.core import metrics as tmet
from repro_torch.models import lenet as tlenet

TOL = 1e-5
MODELS = {"lenet": (jlenet.init_lenet, jlenet.lenet_fwd, tlenet.lenet_fwd),
          "mlp": (jlenet.init_mlp_classifier, jlenet.mlp_classifier_fwd,
                  tlenet.mlp_classifier_fwd)}


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


@pytest.mark.parametrize("model", ["lenet", "mlp"])
def test_flat_layout_matches_ravel_pytree(model):
    init = jax.jit(MODELS[model][0])
    one = init(jax.random.PRNGKey(3))
    nodes = jax.jit(jax.vmap(init))(jax.random.split(jax.random.PRNGKey(4), 3))
    p1 = tlenet.params_from_jax(_numpy_tree(one))
    pn = tlenet.params_from_jax(_numpy_tree(nodes))
    want1 = np.asarray(ravel_pytree(one)[0])
    assert np.array_equal(tlenet.ravel(p1, batch_dims=0).numpy(), want1)
    flat = tlenet.ravel(pn)
    want = np.stack([np.asarray(ravel_pytree(jax.tree.map(lambda x: x[i], nodes))[0])
                     for i in range(3)])
    assert np.array_equal(flat.numpy(), want)
    if model == "lenet":
        assert flat.shape == (3, 44426)          # the paper's d
    back = tlenet.unravel(flat, pn)
    assert all(torch.equal(back[k], pn[k]) for k in pn)


@pytest.mark.parametrize("model", ["lenet", "mlp"])
def test_logits_and_gradients_match_reference(model):
    init, jfwd, tfwd = MODELS[model]
    params = jax.jit(init)(jax.random.PRNGKey(0))
    imgs, labels = jax.jit(JImages().batch, static_argnums=1)(jax.random.PRNGKey(5), 32)
    jloss = lambda p: jmet.cross_entropy(jfwd(p, imgs), labels)   # noqa: E731
    jgrad = ravel_pytree(jax.jit(jax.grad(jloss))(params))[0]

    tp = tlenet.params_from_jax(_numpy_tree(params))
    ti, tl = torch.as_tensor(np.array(imgs)), torch.as_tensor(np.array(labels))
    tgrad = torch.func.grad(lambda p: tmet.cross_entropy(tfwd(p, ti), tl))(tp)
    np.testing.assert_allclose(tfwd(tp, ti).detach().numpy(),
                               np.asarray(jax.jit(jfwd)(params, imgs)),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tlenet.ravel(tgrad, batch_dims=0).numpy(),
                               np.asarray(jgrad), rtol=TOL, atol=TOL)


def test_batched_node_gradients_match_per_node():
    """The engine trains every node at once (vmap of grad over stacked
    parameter dicts); each node's gradient equals its own single call."""
    g = torch.Generator().manual_seed(0)
    params = tlenet.init_lenet(3, g)
    imgs = torch.randn((3, 8, 28, 28, 1), generator=g)
    labels = torch.randint(0, 10, (3, 8), generator=g)
    loss = lambda p, x, y: tmet.cross_entropy(tlenet.lenet_fwd(p, x), y)  # noqa: E731
    batched = torch.func.vmap(torch.func.grad(loss))(params, imgs, labels)
    for n in range(3):
        one = torch.func.grad(loss)({k: v[n] for k, v in params.items()},
                                    imgs[n], labels[n])
        for k in one:
            torch.testing.assert_close(batched[k][n], one[k], rtol=TOL, atol=TOL)
