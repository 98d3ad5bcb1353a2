"""One run of one cell: build, warm up, ramp, measure, check, report.

The order of a run:

1. The cell's requests from the mix and the seed; the weights made on the
   device from the seed; the port's model and engine built from them (the
   kernels' first build, if any, happens here and is timed apart).
2. Warm-up: one prompt for every prefill shape the mix's prompt lengths
   can take, two tokens each, through the engine itself (its decode step's
   graph is captured then).
3. The ramp: the mix's arrivals (or its backlog) start ``ramp_s`` seconds
   before the window, so that the window opens in steady state. Set-up
   ends, and the window begins, when the ramp ends.
4. The window: ``seconds`` of the same traffic (an open loop goes on past
   the close, arrivals and all, until every request due in the window has
   its first token). Under ``--trace 1`` the profiler records the window's
   last ``trace_s`` seconds.
5. The device's peak memory is read, the program's state freed, and the
   served tokens held against the reference (``harness/check.py``); with
   ``control``, the float8 control's first choices in their place.

``setup_s`` runs from the process's start to the window's: in a
checkout's first run it holds the kernels' build, which ``build_s``
reports on its own.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Optional

import numpy as np

from . import check, traffic
from .record import Run
from .system import build_engine, build_params, engine_settings
from .weights import Inputs
from .window import Client, backlog, open_loop, warm_prompt_lengths


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _counters() -> dict:
    from flute_tpu_torch.ops import lut_gemm

    return {"all": sum(lut_gemm.LAUNCHES.values()),
            "mid": sum(lut_gemm.MID_LAUNCHES.values()),
            "wide": sum(lut_gemm.WIDE_LAUNCHES.values())}


def build_kernels() -> None:
    """Build every CUDA source the served engines run (all at once, one
    nvcc each; a built library is found and kept) and load the
    LUT-GEMM's."""
    from flute_tpu_torch.ops import _build, lut_gemm

    _build.build_all(sorted(p.name for p in _build.CSRC.glob("lut_gemm_*.cu"))
                     + ["paged_attention.cu"])
    lut_gemm.build_kernels()


def warm_up(engine, eng: dict, mix: dict, vocab: int) -> int:
    """Serve one two-token request for every prefill shape of the mix;
    returns how many."""
    lo, hi = int(mix["prompt_len"]["min"]), int(mix["prompt_len"]["max"])
    lengths = warm_prompt_lengths(eng, lo, hi)
    for plen in lengths:
        engine.submit([(7 * i + 1) % vocab for i in range(plen)], max_new_tokens=2)
    while engine.step():
        pass
    return len(lengths)


def run_cell(manifest, workload: str, seed: int, seconds: float, trace: bool, *,
             device, t_start: float, log: Callable[[str], None],
             fault: Optional[Callable] = None, control: bool = False) -> tuple:
    """One run of ``workload``; returns ``(result, checks)``: the result
    line's keys but ``checks``, and ``{name: (value, limit)}``."""
    import torch

    w = manifest.workload(workload)
    model = manifest.config(w["config"])
    mix = manifest.traffic(w["traffic"])
    cell = manifest.cell(workload)
    eng = engine_settings(model, mix)
    requests = traffic.generate(mix, seed, model["vocab_size"], eng["max_len"],
                                cell.get("rate_per_s"))
    dev = torch.device(device)

    t0 = time.perf_counter()
    if dev.type == "cuda":
        build_kernels()
    build_s = time.perf_counter() - t0
    inputs = Inputs(model, seed, dev)
    params = build_params(model, inputs, eng["num_slots"])
    _sync(dev)
    t1 = time.perf_counter()
    engine = build_engine(model, mix, params, dev)
    del params  # the engine holds the model
    if fault is not None:
        fault(engine)
    client = Client(engine)
    n_warm = warm_up(engine, eng, mix, model["vocab_size"])
    if trace:
        from .trace import warm

        warm()
    _sync(dev)
    t2 = time.perf_counter()
    log(f"set-up: build {build_s:.2f} s, weights {t1 - t0 - build_s:.2f} s, "
        f"warm-up {t2 - t1:.2f} s ({n_warm} prompts)")

    origin = time.perf_counter()
    w0 = origin + float(mix["ramp_s"])
    w1 = w0 + seconds
    tracer = None
    state = {"first": None, "before": None}
    trace_from = w1 - min(float(mix["trace_s"]), seconds) if trace else float("inf")

    def on_tick(now: float) -> None:
        nonlocal tracer
        if tracer is None and now >= trace_from:
            from .trace import Trace

            state["before"] = _counters()
            tracer = Trace()
            client.range_fn = tracer.range
            state["first"] = len(client.steps)

    if mix["kind"] == "open_loop":
        # past the close, until every request due in the window has its
        # first token: a late answer is late, and its wait is counted
        open_loop(client, requests, origin, w1, on_tick, hold=lambda: any(
            r.first is None for r in client.records if w0 <= r.due < w1))
    else:
        backlog(client, requests, int(mix["backlog"]), w1, on_tick)
    # set-up as a run pays it: the kernels' build too, where one is due (a
    # checkout's first run); build_s says how much of it that was
    setup_s = w0 - t_start

    run = Run(model=model, mix=mix, engine=eng, w0=w0, w1=w1, setup_s=setup_s,
              records=client.records, steps=client.steps)
    if tracer is not None:
        t3 = time.perf_counter()
        run.trace = tracer.stop()
        log(f"trace: {len(run.trace.dev_name)} device operations, "
            f"{len(client.steps) - state['first']} steps, read in "
            f"{time.perf_counter() - t3:.2f} s")
        client.range_fn = None
        after = _counters()
        run.traced = client.steps[state["first"]:]
        run.launches = {k: after[k] - state["before"][k] for k in after}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    metrics = {}
    for m in manifest.metrics(workload, trace):
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    window = run.due_in_window() if mix["kind"] == "open_loop" else \
        [r for r in client.records if r.first is not None and w0 <= r.first < w1]
    finished = [r for r in client.records if r.done]
    failed = sum(1 for r in finished if len(r.tokens) != r.olen)
    result = {"correct": False, "attempted": len(window), "failed": failed,
              "metrics": metrics, "device": device_info(dev, w["chips"], peak)}
    if run.trace is not None:
        lo, hi = run.trace.window
        result["device"]["busy_s"] = run.trace.busy_ns(lo, hi) / 1e9
        result["device"]["window_s"] = (hi - lo) / 1e9
        kinds = {s.index: ("admit" if s.admitted else "decode") for s in run.traced}
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.idle_gaps(kinds)}
        want = run.expected_launches(run.traced)
        log(f"LUT-GEMM calls in the trace: counted {run.launches}, expected {want}")
    late = (f"; late submissions p99 {_late_p99(client.records, w0, w1) * 1e3:.2f} ms"
            if mix["kind"] == "open_loop" else "")
    log(f"window: {len(window)} requests, {len(finished)} finished in all, "
        f"{len(run.window_steps())} steps{late}")

    # the program's state goes before the reference runs (an engine and its
    # step graph refer to each other: only the collector frees them)
    del engine, client
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    limits = cell["limits"]
    picked = check.sample(finished, seed, int(mix["check_requests"]))
    prompts = {r.index: requests[r.index].prompt.tolist() for r in picked}
    checks = {"short_outputs": (failed, 0), "max_logit_gap": (None, limits["max_logit_gap"])}
    if picked:
        t3 = time.perf_counter()
        got = check.served_gaps(model, inputs, picked, prompts, control=control)
        log(f"reference: {len(picked)} requests, {got['tokens_compared']} tokens, "
            f"{time.perf_counter() - t3:.2f} s")
        gap = got["max_logit_gap"]
        if control:
            # the control in the program's place: its first choices are judged
            log(f"control: the program's own widest gap {gap} (limit {limits['max_logit_gap']})")
            gap = got["control_gap"]
        checks["max_logit_gap"] = (gap, limits["max_logit_gap"])
    result["correct"] = all(passes(v, lim) for v, lim in checks.values())
    result["build_s"] = build_s
    return result, checks


def passes(value, limit) -> bool:
    """A compared number within its limit (none read: not within)."""
    return value is not None and value <= limit


def _late_p99(records, w0, w1) -> float:
    late = [r.submitted - r.due for r in records if w0 <= r.due < w1]
    return float(np.percentile(late, 99)) if late else 0.0


def device_info(dev, chips: int, peak: int) -> dict:
    import torch

    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": chips,
            "memory_peak_bytes": int(peak), "power_limit_w": power_limit()}


def power_limit() -> Optional[float]:
    """The card's power limit in watts, as ``nvidia-smi`` reads it."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"], capture_output=True,
                             text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
