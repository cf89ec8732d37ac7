"""Build, bind and launch the single-launch WFAgg round kernel.

The kernel (``csrc/wfagg_round.cu``) replaces the Pallas TPU kernel
``_wfagg_round_indexed_kernel`` / ``wfagg_round_indexed_pallas``
(``src/repro/kernels/robust_stats/kernel.py:367`` / ``:511``).  It is
bound by the bytes it must move: models, prev and local read once, out
written once, at the card's memory rate.  One CTA per receiving node
streams the node's neighbour rows twice (statistics, then the combine);
the second pass hits L2 at the paper's size.  See the source's header
for the design.

It is compiled with ``nvcc`` into a shared library with a plain C entry
point at first use (into ``kernels/_build/``, keyed by the source's
hash) and called through ``ctypes`` on PyTorch's current stream.  Nothing
here runs at import: this module imports on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.common import BUILD_DIR
from repro_torch.kernels.robust_stats.ref import RobustStats

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "wfagg_round.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
MAX_K = 32

# Kernel launches so far in this process: bumped once per launch, right
# where the kernel is launched.  A run that must show it went through the
# kernel sets it to 0 before and reads it after.
launches = 0

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "CUDA kernel cannot be built")


def library_path() -> pathlib.Path:
    """Where the library for the current source and flags lives."""
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libwfagg_round_{tag}.so"


def build() -> pathlib.Path:
    """Compile the kernel unless this source was built already; returns
    the library's path.  The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside it as ``.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                           f"{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.wfagg_round_indexed_launch
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = ([P] * 18 + [I, I, ctypes.c_longlong, I, F, F, F, F, F, I, P])
        fn.restype = I
        _lib = lib
    return _lib


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def wfagg_round_indexed_cuda(
    local: torch.Tensor,         # (N, D) f32
    models: torch.Tensor,        # (M, D) f32
    neighbor_idx: torch.Tensor,  # (N, K) int32, values in [0, M)
    valid: torch.Tensor,         # (N, K) bool
    prev: Optional[torch.Tensor],     # (M, D) f32 or None
    tbands: Optional[torch.Tensor],   # (N, 4K) f32 or None
    cfg,
    alpha: float,
    mean_fallback: bool,
):
    """Launch the round kernel on the tensors' CUDA device and stream.

    Every output is allocated here with ``torch.empty``.  Returns
    ``(out (N, D), weights (N, K), mask_d, mask_c, mask_t ((N, K) bool),
    stats)`` with ``stats`` a ``RobustStats`` of (N, K) / (N,) fields.
    """
    global launches
    M, D = models.shape
    N, K = neighbor_idx.shape
    dev = models.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if not 1 <= K <= MAX_K:
        raise ValueError(f"the round kernel takes 1 <= K <= {MAX_K}, got K={K}")
    _check("models", models, torch.float32, (M, D), dev)
    _check("local", local, torch.float32, (N, D), dev)
    _check("neighbor_idx", neighbor_idx, torch.int32, (N, K), dev)
    _check("valid", valid, torch.bool, (N, K), dev)
    if prev is not None:
        _check("prev", prev, torch.float32, (M, D), dev)
    if tbands is not None:
        if prev is None:
            raise ValueError("tbands requires prev")
        _check("tbands", tbands, torch.float32, (N, 4 * K), dev)
    fn = _load().wfagg_round_indexed_launch

    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((N, D), **f32)
    weights = torch.empty((N, K), **f32)
    masks = [torch.empty((N, K), dtype=torch.bool, device=dev) for _ in range(3)]
    dist2, dotmed, norm2 = (torch.empty((N, K), **f32) for _ in range(3))
    mednorm2 = torch.empty((N,), **f32)
    tail = ([torch.empty((N, K), **f32) for _ in range(3)]
            if prev is not None else [None, None, None])
    floor = float(np.float32(cfg.accept_threshold - 1e-9))
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(_ptr(local), _ptr(models), _ptr(neighbor_idx), _ptr(valid),
                 _ptr(prev), _ptr(tbands), _ptr(out), _ptr(weights),
                 *(_ptr(m) for m in masks), _ptr(dist2), _ptr(dotmed),
                 _ptr(norm2), _ptr(mednorm2), *(_ptr(t) for t in tail),
                 N, K, D, int(cfg.f), float(cfg.tau1), float(cfg.tau2),
                 float(cfg.tau3), floor, float(alpha), int(bool(mean_fallback)),
                 stream)
    if err != 0:
        raise RuntimeError(f"wfagg_round_indexed kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    stats = RobustStats(None, None, dist2, dotmed, norm2, mednorm2, *tail)
    return (out, weights, *masks, stats)
