"""Profiling hooks over ``torch.profiler`` (PyTorch port of
``exponentialutilities_jl_tpu/utils/profiling.py``).

Usage:

    from exponentialutilities_jl_torch.utils.profiling import trace, annotate

    with trace("/path/to/trace-dir"):        # Chrome / TensorBoard trace
        with annotate("expv-production"):
            w = expv(t, op, b, m=30)

A profiler that cannot start is logged and the block still runs, so
library code and scripts can leave the hooks in unconditionally.
"""

from __future__ import annotations

import contextlib
import logging
import os

import torch

__all__ = ["trace", "annotate"]

_log = logging.getLogger(__name__)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (CPU, and CUDA where available) and
    write a Chrome trace into ``log_dir`` (readable by TensorBoard's
    profile plugin and chrome://tracing). Falls back to running the block
    unprofiled when the profiler cannot start."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = None
    try:
        os.makedirs(log_dir, exist_ok=True)
        prof = torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
        prof.__enter__()
    except Exception as e:
        _log.debug("torch.profiler unavailable (%s); trace() runs the block "
                   "unprofiled", e)
        prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
            except Exception as e:
                _log.debug("stopping the profiler failed: %s", e)


def annotate(name: str):
    """A named range in the profiler timeline
    (``torch.profiler.record_function``); a no-op context when it cannot be
    made."""
    try:
        return torch.profiler.record_function(name)
    except Exception:
        return contextlib.nullcontext()
