"""EGM policy steps a cell, summed over its trips (the rows'
``egm_iters``), averaged over the window's cells."""


def read(run):
    return float(run.column("egm").mean())
