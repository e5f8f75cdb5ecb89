"""Bisection trips (supply evaluations) a cell, from the rows'
``bisect_iters``, averaged over the window's cells."""


def read(run):
    return float(run.column("bisect").mean())
