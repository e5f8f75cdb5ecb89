"""From the start of the process to the first timed sweep: imports, the
CUDA context, the kernels' libraries (built or loaded), the warm-up."""


def read(run):
    return run.setup_s
