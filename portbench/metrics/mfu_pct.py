"""Model FLOPs of the window's cells (``portbench/workmodel.model_flops``
over the rows' EGM and distribution steps, the two-point lottery), over
the window times the peak FLOP/s of the cell's dtype, in %."""

from portbench.workmodel import model_flops


def read(run):
    flops = model_flops(float(run.column("egm").sum()),
                        float(run.column("dist").sum()), run.A, run.N,
                        run.D, dense_dist=False)
    return 100.0 * flops / (run.window_s * run.peak_flops)
