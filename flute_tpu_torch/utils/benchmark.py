"""Device-side timing on the GPU, counterpart of
``flute_tpu/utils/benchmark.py``.

The op is launched many times inside one CUDA graph, cycling through
several copies of its inputs whose total size exceeds the L2 cache (so each
launch reads its weights from device memory, as a decode step does), and
the graph's replay is timed with CUDA events. The graph removes the host's
launch cost from the measurement: what is timed is the device's work.
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


def bench_op(
    fn: Callable[..., torch.Tensor],
    arg_sets: Sequence[tuple],
    *,
    min_launches: int = 24,
    reps: int = 3,
) -> float:
    """Seconds per call of ``fn(*args)``, cycling through ``arg_sets``.

    Captures at least ``min_launches`` calls (whole passes over
    ``arg_sets``) into one CUDA graph, replays it ``reps`` times after a
    warm-up replay, and returns the least mean time per call.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("bench_op times the GPU and needs a CUDA device")
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
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3 / n)
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
