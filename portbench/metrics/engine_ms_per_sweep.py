"""The engine's own host work a sweep (``parallel/sweep.run_sweep``
around its batched launches): the host wall of the call less the
engine's ``wall_seconds``, in ms, averaged over the window's sweeps."""


def read(run):
    return 1e3 * sum(s.host_s - s.engine_s for s in run.sweeps) / len(
        run.sweeps)
