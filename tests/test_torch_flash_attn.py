"""Kernel 8 of the port, flash attention, held against the JAX package on
the same numpy inputs.

On the CPU the port's wrapper runs the kernel's plain version
(``flash_attention_plain``); the JAX side runs its Pallas kernel in
interpret mode, as ``tests/test_kernels.py`` does, or its dense oracle.
Tolerances are the reference's own (``tests/test_kernels.py:230``): 2e-5
in f32, 2e-2 in bf16.  The bf16 bound also covers the one deliberate
deviation: the Pallas kernel rounds its running accumulator to bf16 after
every KV block, the port keeps it in f32.  Fully masked rows are compared
exactly (o = 0, m = -1e30, l = 0).  The CUDA kernel itself is held against
the plain version on the card by ``chip_smoke.py``; here the bf16
tensor-core kernel's arithmetic (exact bf16 products summed in f32, ``p``
split into ``kernel.P_TERMS`` bf16 terms for ``P·V``) is emulated in plain
PyTorch and held to the plain version at ``chip_smoke.py``'s tolerance for
bf16 o (rtol 2^-7, atol 1e-5): one bf16 rounding.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.kernel import flash_attention_pallas
from repro.kernels.flash_attn.ops import flash_attention as jflash
from repro_torch.kernels import common
from repro_torch.kernels.flash_attn import kernel as tkernel
from repro_torch.kernels.flash_attn import ops as tops
from repro_torch.kernels.flash_attn import ref as tref
from repro_torch.kernels.flash_attn.ref import NEG_INF, flash_attention_plain

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# chip_smoke.py's O_BF16_RTOL / O_BF16_ATOL: bf16 o within one rounding
O_BF16_RTOL, O_BF16_ATOL = 2.0 ** -7, 1e-5

# the six cases of tests/test_kernels.py:209-216
CASES = [
    (1, 2, 128, 128, 64, True, "float32"),
    (2, 1, 256, 256, 32, True, "float32"),
    (1, 1, 128, 384, 64, True, "float32"),    # decode-style Sq < Sk
    (1, 2, 130, 200, 32, True, "float32"),    # ragged (padding masked)
    (1, 1, 128, 256, 64, False, "float32"),
    (1, 2, 128, 128, 64, True, "bfloat16"),
]


def _inputs(shape_q, shape_k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape_q).astype(np.float32),
            rng.standard_normal(shape_k).astype(np.float32),
            rng.standard_normal(shape_k).astype(np.float32))


def _both(arrays, dtype):
    return ([jnp.asarray(a).astype(jnp.dtype(dtype)) for a in arrays],
            [torch.as_tensor(a).to(getattr(torch, dtype)) for a in arrays])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("route", ["kernel", "dense"])
@pytest.mark.parametrize("B,H,Sq,Sk,hd,causal,dtype", CASES)
def test_wrapper_matches_jax(B, H, Sq, Sk, hd, causal, dtype, route):
    """``ops.flash_attention`` against the JAX wrapper at block 64: the
    kernel route (Pallas in interpret mode on block-padded arrays against
    the port's plain version on unpadded ones) and the dense oracle route
    (``use_kernel=False``)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs((B, H, Sq, hd), (B, H, Sk, hd), 0), dtype)
    scale = 1.0 / np.sqrt(hd)
    use_kernel = route == "kernel"
    want = jflash(jq, jk, jv, scale, causal=causal, block_q=64, block_k=64,
                  use_kernel=use_kernel)
    got = tops.flash_attention(tq, tk, tv, float(scale), causal=causal,
                               use_kernel=use_kernel)
    assert got.dtype == tq.dtype and got.shape == (B, H, Sq, hd)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype], atol=TOL[dtype])


# kernel-level cases on padded (BH, S, hd) arrays:
# (BH, Sq, Sk, hd, causal, sk_valid, q_offset, dtype, block_q, block_k)
BLOCK_CASES = {
    "ragged": (2, 192, 256, 32, True, 200, 70, "float32", 64, 64),
    "fully_masked": (1, 256, 128, 64, True, 128, -128, "float32", 64, 64),
    "hd80": (2, 128, 128, 80, True, 128, 0, "float32", 64, 64),
    "hd128": (1, 128, 256, 128, True, 256, 128, "float32", 128, 128),
    "noncausal_padded": (1, 128, 256, 64, False, 190, 0, "float32", 64, 128),
    "bf16": (2, 128, 128, 64, True, 128, 0, "bfloat16", 64, 64),
    "bf16_hd80_masked": (1, 256, 128, 80, True, 100, -128, "bfloat16", 128, 64),
}


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_plain_blocks_match_pallas(case):
    """The kernel's contract ``(o, m, l)`` against ``flash_attention_pallas``
    in interpret mode: padding past ``sk_valid`` stripped, causal keys
    ``kpos <= row + q_offset``, and rows with no live key exactly o = 0,
    m = -1e30, l = 0 in both."""
    BH, Sq, Sk, hd, causal, sk_valid, q_offset, dtype, bq, bk = BLOCK_CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _both(_inputs((BH, Sq, hd), (BH, Sk, hd), 1), dtype)
    scale = float(1.0 / hd ** 0.5)
    jo, jm, jl = flash_attention_pallas(jq, jk, jv, scale=scale, causal=causal,
                                        sk_valid=sk_valid, q_offset=q_offset,
                                        block_q=bq, block_k=bk, interpret=True)
    to, tm, tl = flash_attention_plain(tq, tk, tv, scale, causal, sk_valid, q_offset)
    assert to.dtype == tq.dtype and tm.dtype == tl.dtype == torch.float32
    tol = TOL[dtype]
    np.testing.assert_allclose(_f32(to), _f32(jo), rtol=tol, atol=tol)
    np.testing.assert_allclose(tm.numpy(), _f32(jm), rtol=tol, atol=tol)
    np.testing.assert_allclose(tl.numpy(), _f32(jl), rtol=tol, atol=tol)
    dead = (np.arange(Sq) + q_offset < 0) if causal else np.zeros(Sq, bool)
    assert dead.any() == (case in ("fully_masked", "bf16_hd80_masked"))
    for o, m, l in ((_f32(to), tm.numpy(), tl.numpy()), (_f32(jo), _f32(jm), _f32(jl))):
        assert np.all(o[:, dead] == 0) and np.all(l[:, dead] == 0)
        assert np.all(m[:, dead] == np.float32(NEG_INF))
        assert np.all(l[:, ~dead] >= 1)      # the row's max contributes exp(0)


def test_plain_row_blocks_are_exact(monkeypatch):
    """The plain version takes its query rows in blocks that keep a score
    block within 1 GiB; rows are independent, so the blocking is exact."""
    q, k, v = (torch.as_tensor(a) for a in _inputs((3, 96, 32), (3, 160, 32), 2))
    whole = flash_attention_plain(q, k, v, 0.2, True, 150, 64)
    monkeypatch.setattr(tref, "_PLAIN_BLOCK_ELEMS", 3 * 160 * 7)     # 7 rows a block
    blocked = flash_attention_plain(q, k, v, 0.2, True, 150, 64)
    for a, b in zip(whole, blocked):
        assert torch.equal(a, b)


def test_kernel_raises_where_it_cannot_run(monkeypatch, tmp_path):
    """No fallback: the CUDA wrapper refuses CPU tensors, the dispatch
    refuses other devices, an unbuilt kernel with no ``nvcc`` raises, and a
    failed launch raises."""
    q = torch.zeros((1, 64, 64))
    with pytest.raises(ValueError, match="CUDA tensors"):
        tkernel.flash_attention_cuda(q, q, q, 0.125, True, 64, 0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.flash_attention_blocks(q.to("meta"), q.to("meta"), q.to("meta"), 0.125, True,
                                    64, 0)
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(common, "_loaded", {})
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        common.load(tkernel.SOURCE, tkernel._bind)
    with pytest.raises(RuntimeError, match="flash_attn kernel launch failed"):
        common.launch_error("flash_attn", 1)


def test_kernel_source_and_counter():
    """The kernel is CUDA C++ for every head dim and dtype the wrapper
    accepts; bf16 runs on the tensor cores (``mma.sync`` on bf16 operands
    with f32 accumulators, ``ldmatrix``, ``cp.async``) with ``p`` split into
    the wrapper's ``P_TERMS`` bf16 terms; the wrapper keeps a launch counter
    for the source and one for the tensor-core kernel."""
    src = tkernel.SOURCE.read_text()
    assert tkernel.SOURCE.suffix == ".cu" and 'extern "C" int flash_attn_launch' in src
    for hd in tkernel.HEAD_DIMS:
        assert f"FLASH_ATTN_CASE({hd})" in src
    assert "__nv_bfloat16" in src and isinstance(tkernel.launches, int)
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    assert "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16" in src and "cp.async" in src
    assert f"constexpr int kPTerms = {tkernel.P_TERMS};" in src
    assert isinstance(tkernel.launches_tc, int)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hd", tkernel.HEAD_DIMS)
def test_split_p_holds_one_bf16_rounding(hd, causal):
    """The tensor-core kernel's arithmetic, emulated by the plain version
    (``p_terms``: bf16 q, k, v products exact in f32, ``p`` split into bf16
    terms for ``P·V``): with ``P_TERMS`` terms its bf16 o stays within one
    rounding of the exact version (ragged Sq, Sk and ``sk_valid`` padding
    included); with one term, FlashAttention's usual rounding of ``p`` to
    bf16, it does not."""
    BH, Sq, Sk, sk_valid = 2, 200, 264, 250
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16)
               for a in _inputs((BH, Sq, hd), (BH, Sk, hd), hd + causal))
    scale = float(1.0 / hd ** 0.5)
    args = (scale, causal, sk_valid, sk_valid - Sq)
    want, m, l = flash_attention_plain(q, k, v, *args)
    assert tkernel.P_TERMS >= 2
    got, gm, gl = flash_attention_plain(q, k, v, *args, p_terms=tkernel.P_TERMS)
    assert torch.equal(gm, m) and torch.equal(gl, l)      # l is summed before the split
    torch.testing.assert_close(got.float(), want.float(), rtol=O_BF16_RTOL, atol=O_BF16_ATOL)
    one = flash_attention_plain(q, k, v, *args, p_terms=1)[0]
    assert not torch.allclose(one.float(), want.float(), rtol=O_BF16_RTOL, atol=O_BF16_ATOL)
