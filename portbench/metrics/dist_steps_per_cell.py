"""Distribution steps a cell, summed over its trips (the rows'
``dist_iters``), averaged over the window's cells."""


def read(run):
    return float(run.column("dist").mean())
