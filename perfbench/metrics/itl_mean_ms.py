"""Inter-token latency, mean, ms: the streaming time (last token - first
token) of every request that finished in the window over their tokens after
the first, every admission stall on the way included. A time per token over
all the window's finished work; the tails stand beside it per layer."""

from harness.readers import itl_mean


def read(run):
    v = itl_mean(run)
    return None if v is None else 1e3 * v
