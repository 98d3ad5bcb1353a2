"""Time to first token, 90th percentile, ms: over every request due in the
window, its first token's arrival at the host minus its due time (the loop
waits past the close for the last of them). A request never answered
counts as missing (infinite). Beside the median: its run-to-run spread is
too wide to bound."""

import math

from harness.readers import percentile, ttft


def read(run):
    t = ttft(run)
    if not t:
        return None
    p = percentile(t, 90)
    return None if math.isinf(p) else 1e3 * p
