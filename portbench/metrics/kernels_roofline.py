"""The least time the window's supply evaluations could take, over the
device time of the program's kernels, in %.

The least time is the larger of the operations over the peak FLOP/s of
the cell's dtype and the bytes over the peak bandwidth
(``portbench/workmodel.py``): the EGM and distribution work of every
lane launch (one a trip) over the EGM and distribution steps the rows
report, whichever kernels ran them, so a fused kernel and the split pair
read the same work.  Which bound binds is noted beside the card's power
limit."""

from portbench.workmodel import supply_work


def read(run):
    if run.trace is None or run.trace.port_launches == 0:
        return None
    nbytes, ops = supply_work(run.itemsize, run.N, run.A, run.D,
                              run.column("bisect").sum(),
                              run.column("egm").sum(),
                              run.column("dist").sum())
    t_ops = ops / run.peak_flops
    t_bytes = nbytes / run.peak_bytes_per_s
    run.notes.append(
        f"kernels_roofline: bound by "
        f"{'compute' if t_ops >= t_bytes else 'bandwidth'} "
        f"({ops:.6g} operations, {nbytes:.6g} bytes, kernels "
        f"{run.trace.port_s:.6g} s)")
    return 100.0 * max(t_ops, t_bytes) / run.trace.port_s
