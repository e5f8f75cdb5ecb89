"""Traced window time in which none of the program's kernels ran on the
device, over the window's bisection trips, in ms: the host's bisection
loop and the plain PyTorch around the kernels."""


def read(run):
    if run.trace is None:
        return None
    return 1e3 * (run.trace.window_s - run.trace.port_union_s) / run.trips
