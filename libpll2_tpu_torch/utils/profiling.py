"""Profiling and tracing hooks.

Port of libpll2_tpu/utils/profiling.py on torch.profiler. The engine's
evaluations and the branch sweep carry JAX's scope names as annotations
(`pll.pmatrix`, `pll.fused_traversal`, `pll.partials`, `pll.edge_logl`;
`sweep.postorder`, `sweep.upclv`, `sweep.sumtable`, `sweep.newton`,
`sweep.pmatrix`), so that a trace attributes host and device time to each
stage; `trace` captures one, and `time_fn` times a call to its device's end.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterator

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["trace", "annotate", "time_fn"]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Capture a host and device trace of the block and write it into
    `log_dir` as a Chrome trace (chrome://tracing, Perfetto):

        with profiling.trace('/tmp/pll-trace'):
            engine.loglikelihood()

    CPU activity always, CUDA activity where a CUDA device is present.
    Yields the profiler, whose `key_averages()` sums the kernels by name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(str(log_dir))
    with torch.profiler.profile(activities=activities,
                                on_trace_ready=handler) as prof:
        yield prof


_NOTHING = contextlib.nullcontext()


def annotate(name: str):
    """A context manager: a named range around its block in the profiler's
    timeline (`torch.profiler.record_function`; an NVTX range under
    `torch.autograd.profiler.emit_nvtx`). Outside a profiler it does
    nothing: one flag test, then a shared null context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NOTHING
    return torch.profiler.record_function(name)


def _sync() -> None:
    """Wait for the device work queued so far (the port launches on the
    current device's stream)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable[[], object], iters: int = 5,
            warmup: int = 1) -> float:
    """Best-of wall-clock seconds for fn(), each call timed to the end of
    its device work (the device is synchronised where CUDA is in use)."""
    for _ in range(warmup):
        fn()
        _sync()
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _sync()
        best = min(best, time.perf_counter() - t0)
    return best
