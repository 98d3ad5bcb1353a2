"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CUPTI) over
the last ``trace_s`` seconds of the window, read from its raw events (no
event tree is built).

What is read: every device operation (kernel, copy, set) with its start and
end; the benchmark's ranges ``bench.step.<n>`` and ``bench.window`` (host
spans in the trace's clock; their copies on the device's timeline are not
operations); every host operation, to name what the host was doing during
the device's idle gaps.

The profiler's first start in a process initialises CUPTI, which takes
seconds: :func:`warm` does that during set-up.
"""

from __future__ import annotations

import re

import numpy as np


def warm() -> None:
    """Start and stop a profiler once, so that a later start in the window
    does not pay CUPTI's initialisation."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)


class Trace:
    """A running profiler; :meth:`stop` returns the read-out."""

    def __init__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._torch = torch
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._window = torch.profiler.record_function("bench.window")
        self._window.__enter__()

    def range(self, name: str):
        return self._torch.profiler.record_function(name)

    def stop(self) -> "TraceData":
        self._window.__exit__(None, None, None)
        if self._torch.cuda.is_available():
            self._torch.cuda.synchronize()
        self._prof.stop()
        return TraceData.from_events(self._prof.profiler.kineto_results.events())


class TraceData:
    """Device operations, host operations and the benchmark's spans, in
    nanoseconds of the trace's clock."""

    def __init__(self, dev_name, dev_start, dev_end, host_name, host_start, host_end, spans,
                 window):
        order = np.argsort(dev_start, kind="stable")
        self.dev_name = [dev_name[i] for i in order]
        self.dev_start = np.asarray(dev_start, np.int64)[order]
        self.dev_end = np.asarray(dev_end, np.int64)[order]
        order = np.argsort(host_start, kind="stable")
        self.host_name = [host_name[i] for i in order]
        self.host_start = np.asarray(host_start, np.int64)[order]
        self.host_end = np.asarray(host_end, np.int64)[order]
        self.spans = spans  # step index -> (start, end)
        self.window = window  # (start, end) of the traced window
        self._busy = None
        self._named = {}  # pattern -> cumulative time of the operations it names

    @classmethod
    def from_events(cls, events) -> "TraceData":
        dev_name, dev_start, dev_end = [], [], []
        host_name, host_start, host_end = [], [], []
        spans, window = {}, None
        for e in events:
            name = e.name()
            start, dur = e.start_ns(), e.duration_ns()
            if str(e.device_type()).endswith("CPU"):
                if name.startswith("bench.step."):
                    spans[int(name[11:])] = (start, start + dur)
                elif name == "bench.window":
                    window = (start, start + dur)
                else:
                    host_name.append(name)
                    host_start.append(start)
                    host_end.append(start + dur)
            elif not name.startswith("bench.") and not _annotation(e):
                dev_name.append(name)
                dev_start.append(start)
                dev_end.append(start + dur)
        if window is None:
            raise RuntimeError("the trace holds no bench.window range")
        return cls(dev_name, dev_start, dev_end, host_name, host_start, host_end, spans, window)

    # -- device time -------------------------------------------------------

    def busy_intervals(self, lo: int, hi: int) -> np.ndarray:
        """The union of device operations clipped to ``[lo, hi)``, as
        ``[n, 2]`` intervals in time order."""
        s = np.clip(self.dev_start, lo, hi)
        e = np.clip(self.dev_end, lo, hi)
        keep = e > s
        s, e = s[keep], e[keep]
        if not len(s):
            return np.zeros((0, 2), np.int64)
        reach = np.maximum.accumulate(e)
        new = np.concatenate([[True], s[1:] > reach[:-1]])
        first = np.flatnonzero(new)
        last = np.concatenate([first[1:] - 1, [len(s) - 1]])
        return np.stack([s[first], reach[last]], axis=1)

    def busy_ns(self, lo: int, hi: int) -> int:
        """Device-busy nanoseconds in ``[lo, hi)``, inside the window."""
        if self._busy is None:
            self._busy = self.busy_intervals(*self.window)
        iv = self._busy
        a = np.searchsorted(iv[:, 1], lo, side="right")
        b = np.searchsorted(iv[:, 0], hi, side="left")
        if b <= a:
            return 0
        part = np.clip(iv[a:b], lo, hi)
        return int((part[:, 1] - part[:, 0]).sum())

    def kernel_ns(self, lo: int, hi: int, pattern: str) -> int:
        """Summed time of device operations named by ``pattern`` (a regular
        expression) that start in ``[lo, hi)``."""
        if pattern not in self._named:
            rx = re.compile(pattern)
            hit = np.fromiter((bool(rx.search(n)) for n in self.dev_name), bool,
                              len(self.dev_name))
            dur = np.where(hit, self.dev_end - self.dev_start, 0)
            self._named[pattern] = np.concatenate([[0], np.cumsum(dur)])
        csum = self._named[pattern]
        a = np.searchsorted(self.dev_start, lo, side="left")
        b = np.searchsorted(self.dev_start, hi, side="left")
        return int(csum[b] - csum[a])

    def top_ops(self, limit: int = 10) -> list:
        """The device operations that took most time in the window, summed
        by name: ``[[name, seconds], ...]``."""
        lo, hi = self.window
        tot = {}
        for name, s, e in zip(self.dev_name, self.dev_start, self.dev_end):
            if lo <= s < hi:
                tot[name] = tot.get(name, 0) + int(e - s)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:limit]
        return [[_short(n), v / 1e9] for n, v in top]

    # -- idle gaps ---------------------------------------------------------

    def idle_gaps(self, step_kind: dict, limit: int = 10) -> list:
        """The device's idle time in the window, summed by what the host
        was doing: the step it was in (``admit``, ``decode``, or ``between
        steps``) and the innermost host operation open at the gap's start.
        ``step_kind`` maps a step index to its kind. Returns the ``limit``
        largest as ``[[name, seconds], ...]``."""
        lo, hi = self.window
        busy = self.busy_intervals(lo, hi)
        starts = np.concatenate([[lo], busy[:, 1]]) if len(busy) else np.asarray([lo])
        ends = np.concatenate([busy[:, 0], [hi]]) if len(busy) else np.asarray([hi])
        keep = ends > starts
        starts, ends = starts[keep], ends[keep]
        span_ids = np.asarray(sorted(self.spans), np.int64)
        sp_start = np.asarray([self.spans[k][0] for k in span_ids], np.int64)
        sp_end = np.asarray([self.spans[k][1] for k in span_ids], np.int64)
        j = np.searchsorted(sp_start, starts, side="right") - 1
        inside = (j >= 0) & (starts < sp_end[np.maximum(j, 0)]) if len(sp_start) else \
            np.zeros(len(starts), bool)
        where = ["between steps" if not ok else step_kind.get(int(span_ids[i]), "step")
                 for ok, i in zip(inside, j)]
        # the innermost host operation open at each gap's start
        parent = np.asarray(_parents(self.host_start, self.host_end), np.int64)
        k = np.searchsorted(self.host_start, starts, side="right") - 1
        for _ in range(64):
            closed = (k >= 0) & (self.host_end[np.maximum(k, 0)] <= starts)
            if not closed.any():
                break
            k[closed] = parent[k[closed]]
        tot = {}
        for w, kk, a, b in zip(where, k, starts, ends):
            key = f"{w}: {_short(self.host_name[kk]) if kk >= 0 else 'no host op'}"
            tot[key] = tot.get(key, 0) + int(b - a)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:limit]
        return [[n, v / 1e9] for n, v in top]


def _annotation(e) -> bool:
    """Whether a device-side event is a copy of a host range."""
    probe = getattr(e, "is_user_annotation", None)
    return bool(probe()) if probe is not None else False


def _parents(start: np.ndarray, end: np.ndarray) -> list:
    """Each host operation's enclosing one (-1 at the top), by a stack
    over operations in start order."""
    parent, stack = [-1] * len(start), []
    for i in range(len(start)):
        while stack and end[stack[-1]] <= start[i]:
            stack.pop()
        parent[i] = stack[-1] if stack else -1
        stack.append(i)
    return parent


def _short(name: str, limit: int = 96) -> str:
    """A kernel's name without its template arguments and parameters."""
    name = re.sub(r"<.*>", "<>", name)
    name = re.sub(r"\(.*\)", "()", name)
    return name[:limit]
