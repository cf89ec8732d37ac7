"""Port parity: ``repro_torch`` ``robust_stats_indexed_ref`` against the
JAX package's oracle (``robust_stats_indexed_ref``) and its gather-free
Pallas kernel (``robust_stats_indexed``, interpret mode on the CPU), on
the same numpy inputs.  Tolerance rtol = atol = 1e-5: float32 sums taken
in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.robust_stats import ops as jops
from repro.kernels.robust_stats import ref as jref
from repro_torch.kernels.robust_stats import ref as tref

from _torch_fixtures import irregular_slate, models, ring_slate, with_degree_zero

TOL = 1e-5
FIELDS = ("dist2", "dotmed", "norm2", "mednorm2", "prev_dist2", "prev_dot",
          "prev_norm2")


def _slate(kind):
    N, K = 7, 5
    if kind == "regular":
        return ring_slate(N, K), None
    idx, valid = with_degree_zero(*irregular_slate(N, K, seed=4, min_degree=1))
    return idx, valid


@pytest.mark.parametrize("prev_form", ["none", "matrix", "prev_idx", "per_edge"])
@pytest.mark.parametrize("slate", ["regular", "irregular"])
def test_indexed_stats_match_reference(slate, prev_form):
    idx, valid = _slate(slate)
    N, K = idx.shape
    d = 203                                  # not a multiple of any tile
    m = models(N, d, seed=1)
    rng = np.random.default_rng(2)
    prev = prev_idx = None
    if prev_form in ("matrix", "prev_idx"):
        prev = models(N, d, seed=3, shift=0.1)
    if prev_form == "prev_idx":
        prev_idx = rng.integers(0, N, (N, K)).astype(np.int32)
    if prev_form == "per_edge":
        prev = rng.standard_normal((N, K, d)).astype(np.float32)

    j = lambda x: None if x is None else jnp.asarray(x)          # noqa: E731
    t = lambda x: None if x is None else torch.as_tensor(x)      # noqa: E731
    got = tref.robust_stats_indexed_ref(t(m), t(idx), t(valid), t(prev),
                                        prev_idx=t(prev_idx))
    oracle = jref.robust_stats_indexed_ref(j(m), j(idx), j(valid), j(prev),
                                           prev_idx=j(prev_idx))
    kernel = jops.robust_stats_indexed(j(m), j(idx), j(valid), j(prev),
                                       prev_idx=j(prev_idx))
    for name in FIELDS:
        g = getattr(got, name)
        if prev is None and name.startswith("prev"):
            assert g is None
            continue
        for want in (oracle, kernel):
            np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want, name)),
                                       rtol=TOL, atol=TOL, err_msg=name)
    assert all(np.isfinite(getattr(got, n).numpy()).all()
               for n in FIELDS if getattr(got, n) is not None)


def test_valid_median_degree_zero_and_dynamic_middles():
    """Even and odd valid counts take the mean of / the dynamic middle(s);
    an empty slate's median is 0."""
    u = torch.tensor([[[4.0], [1.0], [3.0], [9.0]],
                      [[4.0], [1.0], [3.0], [9.0]],
                      [[4.0], [1.0], [3.0], [9.0]]])
    valid = torch.tensor([[True, True, True, False],     # {4, 1, 3} -> 3
                          [True, True, True, True],      # {1, 3, 4, 9} -> 3.5
                          [False, False, False, False]])  # empty -> 0
    med = tref.valid_median(u, valid)
    assert med[:, 0].tolist() == [3.0, 3.5, 0.0]
