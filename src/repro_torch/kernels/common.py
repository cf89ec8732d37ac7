"""Shared kernel plumbing: device resolution, D padding, and the one
``nvcc`` build-and-load helper of every kernel library.

The JAX package picks interpret mode off a TPU; the port has no such
switch.  A wrapper runs its CUDA kernel on a CUDA tensor and its plain
PyTorch version on a CPU tensor, decided by the tensor's device alone,
and the entry points default to the card and raise without one.

Every CUDA source under ``kernels/*/csrc/`` is one shared library with a
plain C entry point: ``nvcc`` compiles it at first use into
``kernels/_build/lib<stem>_<hash>.so`` (the hash covers the source, the
headers beside it and the flags, so an edited source builds anew), keeps the compiler's output
(``-Xptxas -v``: registers, shared memory, spills) beside it as ``.log``,
and ``ctypes`` loads it.  Nothing here runs at import: the modules import
on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Callable, Dict, List, Optional, Union

import torch
import torch.nn.functional as F

# where kernels are compiled at first use (listed in .gitignore)
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[pathlib.Path, ctypes.CDLL] = {}


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """None means the card.  Without one, raise: there is no silent CPU
    fallback; callers that want the CPU (the tests) say so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def pad_d(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad the trailing (D) axis up to a multiple of ``multiple`` and
    promote to f32.  Zero padding is exact for every kernel here: a zero
    column has median 0 and adds nothing to any accumulated statistic,
    distance, dot product or weighted combine."""
    x = x.to(torch.float32)
    pad = (-x.shape[-1]) % multiple
    return F.pad(x, (0, pad)) if pad else x


# ---------------------------------------------------------------------------
# build and load
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the "
                       "CUDA kernels cannot be built")


def library_path(source: pathlib.Path) -> pathlib.Path:
    """Where the library for this source, the headers beside it (``*.cuh``)
    and the current flags lives."""
    text = source.read_bytes() + b"".join(
        h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{source.stem}_{tag}.so"


def build(*sources: pathlib.Path) -> List[pathlib.Path]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together; returns the libraries' paths in order.  Raises
    with the compiler's output if any build fails."""
    libs = [library_path(s) for s in sources]
    todo = [(s, so) for s, so in zip(sources, libs) if not so.exists()]
    if not todo:
        return libs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src, so in todo:
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        procs.append((src, so, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, so, tmp, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{src.name}: nvcc exited with {proc.returncode}:\n{log}")
            continue
        so.with_suffix(".log").write_text(log)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def load(source: pathlib.Path, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``source`` (built first if needed), with its
    entry points' ``argtypes`` set once by ``bind``."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)[0]))
        bind(lib)
        _loaded[source] = lib
    return lib


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
                 device: torch.device) -> None:
    """What every kernel wrapper asks of an argument before it passes the
    pointer: device, dtype, shape and contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_table(neighbor_idx: torch.Tensor, M: int) -> None:
    """The indexed kernels read rows through the table: reject out-of-range
    rows before any pointer is passed (one host read of two integers)."""
    lo, hi = (int(x) for x in torch.aminmax(neighbor_idx))
    if lo < 0 or hi >= M:
        raise ValueError(f"neighbor_idx holds rows in [{lo}, {hi}], outside "
                         f"[0, {M}) of the model matrix")


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def launch_error(name: str, err: int) -> None:
    """Raise if the C entry point reported a CUDA error for the launch."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def grid_blocks(device: torch.device, n_tiles: int, per_sm: int = 4,
                rows: int = 1) -> int:
    """CTAs per row for a grid of ``rows`` rows of a grid-stride kernel over
    ``n_tiles`` tiles each: about ``per_sm`` CTAs per SM of the card over
    the whole grid, at most ``n_tiles`` and at least one per row."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(n_tiles, -(-per_sm * sms // rows)))
