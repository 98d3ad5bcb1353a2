"""Time per output token, median over the requests that finished in the
window, ms, in the paged engine's cell: the steadier statistic beside the
tail."""

from harness.readers import percentile, tpot


def read(run):
    t = tpot(run)
    return 1e3 * percentile(t, 50) if t else None
