"""Engine layer: the host time of the window's admitting steps per
thousand prompt tokens they admitted, ms (open-loop cells)."""

from harness.readers import prefill_ms_per_ktok


def read(run):
    return prefill_ms_per_ktok(run.window_steps())
