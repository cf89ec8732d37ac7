"""Timing plane: first-call-vs-steady wall clock, profiler scopes and the
achieved-bandwidth join against the ``memory_passes`` traffic table (port
of ``repro.obs.profile``).

Everything here is host-side instrumentation around rounds: nothing in
this module runs inside one, so the decision plane's no-host-sync rule is
untouched.  :func:`annotate` names a round for the profilers
(``torch.profiler.record_function``, and an NVTX range on the card), and
:func:`capture` brackets a run with ``torch.profiler.profile`` (CPU and
CUDA activities) and writes a Chrome trace.

Timing methodology: the first call is reported as its own number (there
is no trace or compile: on the card it is the kernel libraries' load, the
cuBLAS / cuDNN handles and the allocator's first blocks); steady state is
the median over ``reps`` further calls, each ended by
``torch.cuda.synchronize()`` on the devices its outputs live on, so one
call's device work is not charged to the next.  On the CPU the host
clock around the call is the time.
"""
from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Any, Callable, List, NamedTuple, Optional

import torch

from repro_torch.core import wfagg as wf


class TimingResult(NamedTuple):
    compile_s: float        # first call: library load + set-up + one run
    steady_s: float         # median of the per-call steady-state times
    steady_all_s: List[float]   # every steady-state sample (reps of them)


def _cuda_devices(out: Any, found: set) -> set:
    """The CUDA devices of every tensor in a nested output."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    return found


def block_until_ready(out: Any) -> Any:
    """Wait for the devices holding ``out``'s tensors (a no-op on the
    CPU) and return ``out``."""
    for dev in _cuda_devices(out, set()):
        torch.cuda.synchronize(dev)
    return out


def time_compile_steady(fn: Callable, *args, reps: int = 5) -> TimingResult:
    """Time ``fn(*args)``: the first call's seconds apart (on the card:
    the kernel libraries' load and cuBLAS set-up, there being no trace or
    compile) and the median of ``reps`` further calls, each waited for on
    its output's devices (host clock on the CPU)."""
    t0 = time.perf_counter()
    block_until_ready(fn(*args))
    compile_s = time.perf_counter() - t0
    samples = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        block_until_ready(fn(*args))
        samples.append(time.perf_counter() - t0)
    return TimingResult(compile_s, statistics.median(samples), samples)


@contextlib.contextmanager
def annotate(name: str):
    """Name a block for the profilers: a ``torch.profiler.record_function``
    range (a span in a :func:`capture` trace) and, with a card, an NVTX
    range."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def capture(logdir: Optional[str]):
    """Opt-in profile of the block: ``torch.profiler.profile`` with CPU
    activity (and CUDA activity when there is a card), exported as a
    Chrome trace to ``logdir/trace.json`` (loadable in Perfetto).  Does
    nothing when ``logdir`` is falsy, so call sites don't branch."""
    if not logdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def round_traffic_bytes(wcfg, n_nodes: int, width: int, d: int, *,
                        indexed: bool = True,
                        include_gather: bool = True) -> float:
    """Analytic bytes moved per gossip round: the ``memory_passes``
    traffic table times the candidate bytes one pass streams: N nodes x
    K candidates x d floats."""
    passes = wf.memory_passes(wcfg, include_gather=include_gather, indexed=indexed)
    return float(passes) * n_nodes * width * d * 4.0


def achieved_bytes_per_s(traffic_bytes: float, steady_s: float) -> float:
    """Achieved bandwidth for one round: analytic traffic over measured
    steady-state seconds."""
    return traffic_bytes / max(steady_s, 1e-12)
