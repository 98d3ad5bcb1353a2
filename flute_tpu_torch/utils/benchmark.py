"""Device-side timing on the GPU, counterpart of
``flute_tpu/utils/benchmark.py``.

Two timers, both of which capture many launches of the op into one CUDA
graph and time its replays with CUDA events, so that the host's launch cost
is left out and what is timed is the device's work:

* :func:`bench_op` takes the JAX package's call form,
  ``bench_op(f, *args, iters=200, reps=3, warmup=True, min_window=0.02)``,
  and calls ``f`` on the same arguments every time. Inputs that fit in the
  card's L2 cache (50 MB on the H100) are read from it after the first
  call: the time is L2-warm.
* :func:`bench_cycled` cycles through several copies of the inputs whose
  total exceeds the L2 cache (:func:`cold_copies`), so each launch reads its
  weights from device memory, as a decode step does: the time is L2-cold.
  Every kernel time the port reports is this timer's.

``format_gemm_report`` prints such a time as the JAX package's one-line
GEMM report.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def cold_copies(bytes_per_set: int, device=None) -> int:
    """How many input copies to cycle through so that their total is at
    least twice the card's L2 cache (and never fewer than 2)."""
    l2 = torch.cuda.get_device_properties(device or 0).L2_cache_size
    return max(2, -(-2 * l2 // max(1, bytes_per_set)) + 1)


def _timed_replays(graph: torch.cuda.CUDAGraph, replays: int, reps: int) -> float:
    """The least of ``reps`` CUDA-event times, in seconds, of ``replays``
    back-to-back replays of ``graph`` (after one untimed replay)."""
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(reps):
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def bench_op(
    f: Callable[..., torch.Tensor],
    *args,
    iters: int = 200,
    reps: int = 3,
    warmup: bool = True,
    min_window: float = 0.02,
) -> float:
    """Seconds per call of ``f(*args)``, the same arguments every call.

    The parameters are those of the JAX package's ``bench_op``, in its
    order. ``warmup`` makes one eager call first, which builds the op's
    kernels and grows the allocator. Then ``iters`` calls are captured into
    one CUDA graph, and the least of ``reps`` timed windows of its replays
    is returned, per call. A window starts at one replay and doubles, at
    most 7 times, while it takes less than ``min_window`` seconds, as JAX's
    window grows. ``f`` is called ``iters`` times in all, plus one with
    ``warmup``; the replays call no Python.

    With ``warmup=False`` no eager call is made, so the op's kernels must
    already be built: a kernel is never built inside a capture, and a
    capture that would build one raises. The inputs are read from the L2
    cache wherever they fit in it (50 MB on the H100): :func:`bench_cycled`
    is the L2-cold timer. Times the GPU, and raises without a CUDA device.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("bench_op times the GPU and needs a CUDA device")
    if warmup:
        f(*args)
        torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(iters):
                f(*args)
    except RuntimeError as e:
        if warmup:
            raise
        raise RuntimeError(
            "bench_op(warmup=False) could not capture the op: its kernels must be "
            "built before (call it once, or pass warmup=True)") from e
    replays = 1
    window = _timed_replays(graph, replays, reps)
    for _ in range(7):
        if window >= min_window:
            break
        replays *= 2
        window = _timed_replays(graph, replays, reps)
    del graph
    return window / (replays * iters)


def bench_cycled(
    fn: Callable[..., torch.Tensor],
    arg_sets: Sequence[tuple],
    *,
    min_launches: int = 24,
    reps: int = 3,
) -> float:
    """Seconds per call of ``fn(*args)``, cycling through ``arg_sets``: the
    L2-cold timer of every kernel time the port reports.

    ``arg_sets`` are copies of the inputs (:func:`cold_copies` of them make
    each launch read its weights from device memory). Captures at least
    ``min_launches`` calls (whole passes over ``arg_sets``) into one CUDA
    graph, replays it ``reps`` times after a warm-up replay, and returns the
    least mean time per call. The first call on each set, made eagerly
    before the capture, builds the kernels and grows the allocator. The
    JAX package has no such timer: its ``bench_op`` form is
    :func:`bench_op`'s.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("bench_cycled times the GPU and needs a CUDA device")
    for args in arg_sets:  # first calls: builds, allocator growth
        fn(*args)
    torch.cuda.synchronize()
    passes = -(-min_launches // len(arg_sets))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(passes):
            for args in arg_sets:
                fn(*args)
    n = passes * len(arg_sets)
    best = _timed_replays(graph, 1, reps) / n
    del graph
    return best


def format_gemm_report(
    name: str,
    dt: float,
    m: int,
    n: int,
    k: int,
    num_bits: int,
    hbm_gbps: float,
    extra_bytes: int = 0,
) -> str:
    """One line on a GEMM of ``num_bits``-bit weights ``[k, n]`` that took
    ``dt`` seconds at ``m`` rows: its µs, the GB/s of the weight bytes and
    ``extra_bytes``, that rate's share of ``hbm_gbps`` (the card's memory
    rate, which the caller passes: 3350 GB/s on the H100), and its TFLOP/s."""
    weight_bytes = k * n * num_bits / 8
    total = weight_bytes + extra_bytes
    bw = total / dt / 1e9
    pct = 100.0 * bw / hbm_gbps
    tflops = 2 * m * n * k / dt / 1e12
    return (
        f"{name}: {dt * 1e6:8.1f} us  {bw:7.1f} GB/s ({pct:5.1f}% roofline)"
        f"  {tflops:6.2f} TFLOP/s"
    )
