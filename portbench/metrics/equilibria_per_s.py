"""Cells solved with a non-failing status, over the window: every sweep
that ran in it, over all of its time (the window closes when the last
sweep started in it returns)."""


def read(run):
    return float((~run.column("failed")).sum()) / run.window_s
