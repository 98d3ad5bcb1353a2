"""Model step: the useful model operations of the window's decode steps
(two per weight and decoded row, the head, attention over each row's
context) over their host time at 989 TFLOP/s, percent, in the paged
engine's cell."""

from harness.readers import decode_steps, step_mfu


def read(run):
    return step_mfu(run, decode_steps(run.window_steps()))
