"""Time to first token, 75th percentile, ms: over every request due in the
window, its first token's arrival at the host minus its due time (the loop
waits past the close for the last of them; one never answered counts as
missing). Beside the median, which stands end to end."""

import math

from harness.readers import percentile, ttft


def read(run):
    t = ttft(run)
    if not t:
        return None
    p = percentile(t, 75)
    return None if math.isinf(p) else 1e3 * p
