"""Engine layer: the mean host time of the window's steps that admitted
nothing (a decode step of every slot, with its sampling), ms."""

from harness.readers import decode_steps


def read(run):
    steps = decode_steps(run.window_steps())
    return 1e3 * sum(s.t1 - s.t0 for s in steps) / len(steps) if steps else None
