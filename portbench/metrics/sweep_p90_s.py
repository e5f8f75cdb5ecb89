"""The 90th percentile of the window's sweep walls, each from the call
into the engine until its rows are on the host."""

import numpy as np


def read(run):
    return float(np.percentile([s.host_s for s in run.sweeps], 90))
