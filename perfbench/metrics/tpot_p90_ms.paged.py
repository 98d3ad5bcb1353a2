"""Time per output token, 90th percentile, ms, in the paged engine's cell:
over the requests that finished in the window, (last token - first token)
/ (tokens - 1), with every admission stall on the way. Beside the
mean inter-token latency, which stands end to end."""

from harness.readers import percentile, tpot


def read(run):
    t = tpot(run)
    return 1e3 * percentile(t, 90) if t else None
