"""What the metric readers share: percentiles, step selections, and the
arithmetic of rates, model FLOP utilisation and roofline shares. Each
metric's own file (``perfbench/metrics/<name>.py``) picks its steps and
calls these."""

from __future__ import annotations

import math

from . import counts

# the LUT-GEMM's device operations, by kernel name: the decode loop, its
# split-K reduction, the wide-M kernel (and its mid route), the SIMT kernels
LUT_GEMM_KERNELS = r"lut_mma_kernel|split_reduce_kernel|wide_m_kernel|lut_qgemm_\w+_kernel"


def percentile(values: list, q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least ``q`` percent of the values at or below it (``inf`` counts as a
    value: a request that missed)."""
    if not values:
        return math.nan
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def ttft(run) -> list:
    """Seconds from due to first token of every request due in the window
    (``inf`` for one never answered)."""
    return [r.first - r.due if r.first is not None else math.inf for r in run.due_in_window()]


def _finished(run) -> list:
    return [r for r in run.records if r.done and len(r.tokens) > 1 and run.w0 <= r.last < run.w1]


def tpot(run) -> list:
    """Seconds per output token after the first, of every request that
    finished in the window."""
    return [(r.last - r.first) / (len(r.tokens) - 1) for r in _finished(run)]


def itl_mean(run):
    """Seconds between tokens, over every token after the first of the
    requests that finished in the window: their streaming time over their
    tokens, a sum over a sum (None when none finished)."""
    done = _finished(run)
    gaps = sum(len(r.tokens) - 1 for r in done)
    return sum(r.last - r.first for r in done) / gaps if gaps else None


def decode_steps(steps: list) -> list:
    """Steps that admitted nothing and decoded."""
    return [s for s in steps if not s.admitted and s.contexts]


def admit_steps(steps: list) -> list:
    return [s for s in steps if s.admitted]


def prefill_ms_per_ktok(steps: list):
    """Host time of the admitting steps per thousand prompt tokens
    admitted."""
    adm = admit_steps(steps)
    tokens = sum(sum(s.admitted) for s in adm)
    if not tokens:
        return None
    return sum(s.t1 - s.t0 for s in adm) / tokens * 1e6


def step_mfu(run, steps: list):
    """The steps' useful model operations over their host time at the
    chip's peak, in percent."""
    secs = sum(s.t1 - s.t0 for s in steps)
    if not steps or secs <= 0:
        return None
    flops = sum(sum(counts.prefill_flops(run.model, p) for p in s.admitted)
                + counts.decode_flops(run.model, s.contexts) for s in steps)
    return 100.0 * flops / (secs * counts.PEAK_FLOPS)


def lut_roofline(run, steps: list):
    """The least time of the steps' LUT-GEMM calls over their device time,
    in percent."""
    if run.trace is None or not steps:
        return None
    dev = sum(run.device_ns(s, LUT_GEMM_KERNELS) for s in steps) / 1e9
    if dev <= 0:
        return None
    return 100.0 * run.lut_least_s([c for s in steps for c in run.lut_calls(s)]) / dev


def idle_share(run, steps: list):
    """1 - device-busy time inside the steps' spans / their wall time, in
    percent."""
    if run.trace is None or not steps:
        return None
    wall = sum(run.span_ns(s) for s in steps)
    if wall <= 0:
        return None
    return 100.0 * (1.0 - sum(run.busy_ns(s) for s in steps) / wall)
