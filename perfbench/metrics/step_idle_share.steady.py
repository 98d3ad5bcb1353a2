"""Device: 1 - the device-busy time inside the traced steps' spans over
the spans' wall time, percent (the dense engine's chat cell)."""

from harness.readers import idle_share


def read(run):
    return idle_share(run, run.traced)
