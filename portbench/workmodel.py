"""The yardstick's work model and peaks, frozen here so that a change to
the program cannot move them unseen.

``egm_work``, ``dist_work`` and ``model_flops`` are copies of the port's
``obs/profile.egm_work``, ``obs/profile.dist_work`` and
``utils/timing.model_flops`` as they stood when the benchmark was
defined; ``portbench/tests/test_portbench_workmodel.py`` holds them
equal to the program's functions.  The peaks are NVIDIA's data-sheet
numbers for one H100 SXM (80 GB HBM3) at its full 700 W: plain FP64 and
FP32 outside the tensor cores, and HBM3 bandwidth.
"""

from __future__ import annotations

import math
from typing import Optional

PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12


def egm_work(itemsize: int, lanes: int, n_states: int, a_count: int,
             steps: float, knots: Optional[int] = None):
    """(bytes, operations) of the EGM fixed points of one launch: inputs
    read once, outputs written once; per step and lane, per (state,
    asset) pair 3 flops for m', ~log2(K) compares and 5 flops of
    interpolation, a pow, 2N-1 for the expectation, a pow and 2 more; 4
    per knot for the sup-norm; every 32nd step 8 more per knot.  ``knots``
    K defaults to A + 1."""
    s, N, A = int(itemsize), int(n_states), int(a_count)
    K = A + 1 if knots is None else int(knots)
    nbytes = lanes * (s * (2 * N * K + A + N + N * N + 5) + s * 2 * N * K
                      + 4 + s)
    per_step = (N * A * (3 + math.log2(K) + 5 + 1 + (2 * N - 1) + 3)
                + 4 * N * K + 8 * N * K / 32)
    return float(nbytes), per_step * float(steps)


def dist_work(itemsize: int, lanes: int, n_states: int, d_count: int,
              steps: float):
    """(bytes, operations) of the distribution fixed points of one launch:
    inputs (int64 index, weight, P, dist0) read once, outputs written
    once; per step and lane 4 D N flops of lottery, D N (2N-1) of labor
    mix, 2 D N for the sup-norm, and every 64th step 10 D N more."""
    s, N, D = int(itemsize), int(n_states), int(d_count)
    dn = D * N
    nbytes = lanes * (8 * dn + s * dn + s * N * N + s * dn + s * dn + 4 + s)
    per_step = dn * (4 + (2 * N - 1) + 2) + 10 * dn / 64
    return float(nbytes), per_step * float(steps)


def model_flops(egm_iters: float, dist_iters: float, a_count: int,
                n_states: int, d_count: int, dense_dist: bool) -> float:
    """Model FLOPs of counted inner-loop work: per EGM step the
    expectation (2 A N^2) and ~12 A N of interpolation; per distribution
    step the labor mix (2 D N^2) plus the dense lottery (2 N D^2) or the
    two-point scatter (~6 D N)."""
    egm = egm_iters * (2.0 * a_count * n_states ** 2
                       + 12.0 * a_count * n_states)
    per_dist = 2.0 * d_count * n_states ** 2
    per_dist += (2.0 * n_states * d_count ** 2 if dense_dist
                 else 6.0 * d_count * n_states)
    return egm + dist_iters * per_dist


def supply_work(itemsize: int, n_states: int, a_count: int, d_count: int,
                evaluations: float, egm_steps: float, dist_steps: float):
    """(bytes, operations) of supply evaluations, whichever kernels ran
    them: the EGM and distribution work of ``evaluations`` lane launches
    (each lane's inputs read and outputs written once a launch) over the
    steps the rows report."""
    eb, eo = egm_work(itemsize, 1, n_states, a_count, egm_steps)
    db, do = dist_work(itemsize, 1, n_states, d_count, dist_steps)
    return (eb + db) * float(evaluations), eo + do
