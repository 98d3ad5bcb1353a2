"""Profiling and observability helpers; counterpart of
``flute_tpu/utils/profiling.py``.

``device_trace`` records a ``torch.profiler`` trace (host ops and, on a
GPU, the kernels CUPTI sees, those replayed from a CUDA graph among them)
and writes it as a Chrome trace, viewable in Perfetto or
``chrome://tracing``; ``annotate`` names a region on that timeline;
``timed`` and ``log_event`` log to the package's logger.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time
from typing import Iterator

import torch

logger = logging.getLogger("flute_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter("[flute-tpu-torch] %(levelname)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed code and write ``log_dir/trace.json`` (a Chrome
    trace) when it ends. CPU activity always; CUDA activity too where a GPU
    is present. Yields the profiler, whose ``key_averages()`` and
    ``events()`` read the same record."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region on the profiler timeline (host, and the device work it
    launches)."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def timed(name: str, sync: bool = False) -> Iterator[None]:
    """Wall-clock timer with structured log output; ``sync`` waits for the
    GPU's queued work before reading the clock."""
    t0 = time.perf_counter()
    yield
    if sync and torch.cuda.is_available():
        torch.cuda.synchronize()
    logger.info("%s took %.3fs", name, time.perf_counter() - t0)


def log_event(event: str, **fields) -> None:
    """One-line JSON event (quantization progress, tuning decisions...)."""
    logger.info("%s %s", event, json.dumps(fields, sort_keys=True, default=str))
