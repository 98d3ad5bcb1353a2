"""Set-up time, s: from the process's start to the window's start: the
kernels' build where one is due, the weights made and quantized on the
card, the warm-up of every prefill shape, and the traffic's ramp."""


def read(run):
    return run.setup_s
