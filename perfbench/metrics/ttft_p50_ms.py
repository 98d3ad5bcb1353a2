"""Time to first token, median, ms: over every request due in the window,
its first token's arrival at the host minus its due time (the loop waits
past the close for the last of them; one never answered counts as missing).
The median: at a window's ~100 requests the tails' run-to-run spread allows
no bound; they stand beside it per layer."""

import math

from harness.readers import percentile, ttft


def read(run):
    t = ttft(run)
    if not t:
        return None
    p = percentile(t, 50)
    return None if math.isinf(p) else 1e3 * p
