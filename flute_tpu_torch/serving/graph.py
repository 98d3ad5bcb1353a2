"""A decode step captured once in a CUDA graph and replayed, the port's
counterpart of the reference's ``jax.jit``-compiled step.

A T = 1 step has fixed shapes: the engine keeps its inputs in device
tensors at fixed addresses (tokens, positions, block tables) and writes
them before each step, so one capture serves every step after it. The
first call runs the step eagerly on a side stream (it builds the kernels,
fills the wrappers' caches and sets the kernels' shared-memory limits) and
returns its output; it then captures the step on that stream. Every later
call replays the graph and returns the output tensor of the capture, which
the next replay overwrites. A kernel that fails to launch or to capture
raises; nothing falls back to the eager step.

An engine and its graph refer to each other, so a dropped engine's graph
is freed by the garbage collector; a graph destroyed while another is
being captured ends that capture. The capture therefore collects first and
keeps the collector off while it runs.

The kernels' wrappers count launches on the host, so they see the capture
and not the replays. The capture's counts are taken back and kept, and
every replay adds them again: ``LAUNCHES`` keeps counting the launches
that ran.
"""

from __future__ import annotations

import gc
from typing import Callable, Optional

import torch

from flute_tpu_torch.ops import lut_gemm
from flute_tpu_torch.ops import paged_attention

# the launch counters of the kernels a served step runs (WIDE_LAUNCHES: the
# wide-M kernel's, by layout, K1-K4; MID_LAUNCHES: its mid route's, K1-K4)
COUNTERS = (lut_gemm.LAUNCHES, paged_attention.LAUNCHES, lut_gemm.WIDE_LAUNCHES,
            lut_gemm.MID_LAUNCHES)


class StepGraph:
    """``step()`` (reading only tensors whose addresses never change)
    captured at the first call and replayed at every later one, on
    ``device``."""

    def __init__(self, step: Callable[[], torch.Tensor], device: torch.device):
        self._step = step
        self._device = device
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._out: Optional[torch.Tensor] = None
        self._counts: list[dict] = []

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def __call__(self) -> torch.Tensor:
        if self._graph is None:
            return self._capture()
        self._graph.replay()
        for counter, counts in zip(COUNTERS, self._counts):
            for kernel, n in counts.items():
                counter[kernel] += n
        return self._out

    def _capture(self) -> torch.Tensor:
        side = torch.cuda.Stream(self._device)
        side.wait_stream(torch.cuda.current_stream(self._device))
        with torch.cuda.stream(side):
            out = self._step()  # the warm-up: a real step, counted as one
        current = torch.cuda.current_stream(self._device)
        current.wait_stream(side)
        out.record_stream(current)  # the caller reads it on its own stream
        before = [dict(c) for c in COUNTERS]
        graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=side):
                self._out = self._step()
        finally:
            if collecting:
                gc.enable()
        self._counts = [{k: c[k] - b[k] for k in c if c[k] != b[k]}
                        for c, b in zip(COUNTERS, before)]
        for c, b in zip(COUNTERS, before):  # the capture launched nothing
            c.update(b)
        self._graph = graph
        return out
