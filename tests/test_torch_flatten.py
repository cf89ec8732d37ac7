"""Port parity of ``repro_torch.core.flatten``: the ravel of a port
``DecoderLM`` (``params_from_jax`` of the reference's tree) is
``ravel_pytree``'s vector of that tree bit for bit, on the reduced
Qwen1.5-0.5B; the flat layout, the unravel round trip, the stacked views
and ``tree_size`` / ``tree_bytes``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.configs.registry import get_config as jget_config
from repro.core import flatten as jflat
from repro.models import model as JM
from repro_torch.configs.registry import get_config
from repro_torch.core import flatten as F
from repro_torch.models import model as TM


@pytest.fixture(scope="module")
def qwen():
    cfg = get_config("qwen1.5-0.5b").reduced()
    tree = jax.tree.map(np.asarray, JM.init_params(jget_config("qwen1.5-0.5b").reduced(),
                                                   jax.random.PRNGKey(0)))
    return cfg, tree


def test_module_ravel_is_ravel_pytree(qwen):
    cfg, tree = qwen
    want = np.asarray(ravel_pytree(tree)[0])
    model = TM.params_from_jax(tree, cfg, device="cpu")
    vec, unravel = F.tree_ravel(model)
    assert vec.numpy().tobytes() == want.tobytes()
    # laid out on one buffer: the buffer itself is the ravel
    flat = F.layout_flat(model)
    assert flat.numpy().tobytes() == want.tobytes()
    assert F.flat_buffer(model).data_ptr() == flat.data_ptr()
    assert F.layout_flat(model).data_ptr() == flat.data_ptr()       # no second copy
    assert F.tree_ravel(model)[0].numpy().tobytes() == want.tobytes()
    # every parameter is a view of the buffer, in the reference's order
    for p in model.parameters():
        assert p.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
    # and the model computes as before
    tok = {"tokens": torch.arange(24).reshape(2, 12) % cfg.vocab_size}
    ref = TM.params_from_jax(tree, cfg, device="cpu")
    with torch.no_grad():
        assert torch.equal(TM.forward(cfg, model, tok)[0], TM.forward(cfg, ref, tok)[0])


def test_module_tree_is_the_reference_tree(qwen):
    cfg, tree = qwen
    model = TM.params_from_jax(tree, cfg, device="cpu")
    for laid_out in (False, True):
        if laid_out:
            flat = F.layout_flat(model)
        got = F.module_tree(model)
        assert jax.tree.structure(got) == jax.tree.structure(tree)
        for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(tree)[0],
                                F.tree_leaves(got)):
            assert g.numpy().tobytes() == w.tobytes(), jax.tree_util.keystr(path)
            if laid_out:      # views of the buffer, the stacked leaves included
                assert g.untyped_storage().data_ptr() == flat.untyped_storage().data_ptr()
    # writing a stacked view writes the layer's parameter
    got["layers"]["attn"]["wq"][1].fill_(3.0)
    assert bool((model.layers[1].attn.wq == 3.0).all())


def test_unravel_round_trip_and_sizes(qwen):
    cfg, tree = qwen
    t = jax.tree.map(lambda x: torch.as_tensor(np.asarray(x)), tree)
    vec, unravel = F.tree_ravel(t)
    back = unravel(vec)
    for a, b in zip(F.tree_leaves(back), F.tree_leaves(t)):
        assert torch.equal(a, b)
        assert a.untyped_storage().data_ptr() == vec.untyped_storage().data_ptr()
    jt = jax.tree.map(jnp.asarray, tree)
    assert F.tree_size(t) == jflat.tree_size(jt) == vec.numel()
    assert F.tree_bytes(t) == jflat.tree_bytes(jt) == 4 * vec.numel()
    model = TM.params_from_jax(tree, cfg, device="cpu")
    assert F.tree_size(model) == vec.numel()
    assert torch.equal(F.unravel_like(vec, t)["embedding"]["embed"], t["embedding"]["embed"])


def test_stack_and_vmap_ravel_match_reference():
    rng = np.random.default_rng(0)
    trees = [{"b": rng.standard_normal((5,)).astype(np.float32),
              "a": {"w": rng.standard_normal((2, 3)).astype(np.float32)}} for _ in range(4)]
    mj, _ = jflat.tree_stack_ravel([jax.tree.map(jnp.asarray, t) for t in trees])
    tt = [jax.tree.map(torch.as_tensor, t) for t in trees]
    mt, unravel = F.tree_stack_ravel(tt)
    assert mt.numpy().tobytes() == np.asarray(mj).tobytes()
    batched = jax.tree.map(lambda *xs: np.stack(xs), *trees)
    vj, _ = jflat.vmap_ravel(jax.tree.map(jnp.asarray, batched))
    vt, unravel_one = F.vmap_ravel(jax.tree.map(torch.as_tensor, batched))
    assert vt.numpy().tobytes() == np.asarray(vj).tobytes()
    assert torch.equal(unravel_one(vt[2])["a"]["w"], tt[2]["a"]["w"])
    # the stacked views of a (K, P) matrix: column blocks in ravel order
    rows = F.unravel_rows(vt, tt[0])
    assert torch.equal(rows["a"]["w"][3], tt[3]["a"]["w"])
    assert rows["b"].untyped_storage().data_ptr() == vt.untyped_storage().data_ptr()
    with pytest.raises(ValueError, match="columns"):
        F.unravel_rows(vt[:, :-1], tt[0])
