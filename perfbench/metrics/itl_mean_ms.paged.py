"""Inter-token latency, mean, ms, in the paged engine's cell: the streaming
time of every request that finished in the window over their tokens after
the first, every admission stall on the way included."""

from harness.readers import itl_mean


def read(run):
    v = itl_mean(run)
    return None if v is None else 1e3 * v
