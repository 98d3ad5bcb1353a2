"""What a run hands to the metric readers (``perfbench/metrics/*.py``).

A reader takes a :class:`Run` and returns a number or None. The helpers
here give each reader the same view: the window's requests and steps
(host clock), the traced steps with their spans and device time (trace
clock), the LUT-GEMM calls each step made, and the yardstick's counts.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from . import counts


@dataclasses.dataclass
class Run:
    model: dict
    mix: dict
    engine: dict
    w0: float  # window start, host clock
    w1: float  # window end
    setup_s: float
    records: list  # every request submitted after warm-up
    steps: list  # every step after warm-up
    trace: Optional[object] = None  # trace.TraceData of a --trace 1 run
    traced: list = dataclasses.field(default_factory=list)  # steps inside the trace
    launches: dict = dataclasses.field(default_factory=dict)  # counters' deltas there

    @property
    def seconds(self) -> float:
        return self.w1 - self.w0

    def window_steps(self) -> list:
        """Steps that began inside the window."""
        return [s for s in self.steps if self.w0 <= s.t0 < self.w1]

    def due_in_window(self) -> list:
        return [r for r in self.records if self.w0 <= r.due < self.w1]

    # -- trace helpers ------------------------------------------------------

    def span(self, step) -> tuple:
        return self.trace.spans[step.index]

    def device_ns(self, step, pattern: str) -> int:
        """Device time of the operations named by ``pattern`` that started
        inside the step's span."""
        return self.trace.kernel_ns(*self.span(step), pattern)

    def busy_ns(self, step) -> int:
        return self.trace.busy_ns(*self.span(step))

    def span_ns(self, step) -> int:
        a, b = self.span(step)
        return b - a

    # -- the benchmark's own count of LUT-GEMM calls -----------------------

    def lut_calls(self, step, launched: bool = False) -> list:
        """``(M, N, K)`` of every LUT-GEMM call of ``step``: each admitted
        prompt's prefill calls (the engine's chunks), then the decode step
        when any request was decoded. ``M`` is the real rows (the prompt's
        tokens in the chunk; the requests decoded), or with ``launched``
        the rows the kernels run (the padded bucket; every slot)."""
        pick = 1 if launched else 0
        rows = [c[pick] for plen in step.admitted for c in counts.prefill_chunks(self.engine, plen)]
        if step.contexts:
            rows.append(self.engine["num_slots"] if launched else len(step.contexts))
        return [c for m in rows for c in counts.layer_calls(self.model, m)]

    def lut_least_s(self, calls: list) -> float:
        q = self.model["quant"]
        return sum(counts.lut_least_s(m, n, k, q["format"], q["group_size"])
                   for m, n, k in calls)

    def expected_launches(self, steps: list) -> dict:
        """Calls of ``steps`` by route (``loop``, ``mid``, ``wide``) and in
        all, from the benchmark's count."""
        out = {"all": 0, "loop": 0, "mid": 0, "wide": 0}
        for s in steps:
            for m, _, _ in self.lut_calls(s, launched=True):
                out["all"] += 1
                out[counts.route(m)] += 1
        return out
