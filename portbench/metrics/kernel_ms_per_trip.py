"""Device time of the program's kernels (those its CUDA sources declare
``__global__``), from the profiler's trace, over the window's bisection
trips, in ms."""


def read(run):
    if run.trace is None or run.trace.port_launches == 0:
        return None
    return 1e3 * run.trace.port_s / run.trips
