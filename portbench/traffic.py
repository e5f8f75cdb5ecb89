"""The one generator of the benchmark's traffic: calibration sweeps.

A traffic mix is a JSON file of parameters (``portbench/workloads/
<traffic>.json``).  Its sweeps come from a closed loop of one client: the
next sweep is submitted when the last one's rows are back, as a
calibration or estimation loop does.

Each sweep is a Latin hypercube of ``cells_per_sweep`` cells over the
mix's box of (crra, rho, sd): each coordinate's range cut into as many
equal strata as the sweep has cells, one cell at a uniform point within
each stratum, the strata of the coordinates paired by independent
permutations.  Sweep ``k`` of the window is drawn from its own stream of
``SWEEP_SEED``, the same in every run, so no sweep repeats another's
cells and every seed gets the same work: the run's seed orders each
sweep's lanes (and draws the warm-up and the check's sample).  A sweep's
slowest lane sets its wall, so sweeps drawn from the run's seed would
move the rate with the seed (several % at four cells a sweep).

Streams: the window's sweeps, the warm-up sweeps (drawn from the run's
seed, apart from the window's), the check's sample and the lanes' order
each draw from their own ``SeedSequence`` branch.
"""

from __future__ import annotations

import numpy as np

AXES = ("crra", "rho", "sd")
(STREAM_WINDOW, STREAM_WARMUP, STREAM_CHECK, STREAM_LANES) = range(4)
# The seed of the window's sweeps, shared by every run.
SWEEP_SEED = 1994


def rng(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    """The generator of one stream of a seed (any non-negative integer)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed), int(stream), int(index)]))


def hypercube(traffic: dict, g: np.random.Generator) -> np.ndarray:
    """One sweep's [C, 3] cells, a Latin hypercube over the box."""
    C = int(traffic["cells_per_sweep"])
    lo = np.array([float(traffic["box"][a][0]) for a in AXES])
    hi = np.array([float(traffic["box"][a][1]) for a in AXES])
    u = np.stack([(g.permutation(C) + g.random(C)) / C for _ in AXES],
                 axis=1)
    return lo + u * (hi - lo)


def sweep_cells(traffic: dict, seed: int, index: int,
                stream: int = STREAM_WINDOW) -> np.ndarray:
    """The [C, 3] cells of sweep ``index`` of a stream: of the window,
    ``SWEEP_SEED``'s sweep in the seed's lane order; of the warm-up, a
    draw from the seed."""
    if stream != STREAM_WINDOW:
        return hypercube(traffic, rng(seed, stream, index))
    sweep = hypercube(traffic, rng(SWEEP_SEED, STREAM_WINDOW, index))
    return sweep[rng(seed, STREAM_LANES, index).permutation(len(sweep))]


def check_sample(n_cells: int, n_check: int, seed: int,
                 must: int | None = None) -> np.ndarray:
    """Indices of ``n_check`` of ``n_cells`` answers to check, drawn from
    the seed, with ``must`` among them when given."""
    g = rng(seed, STREAM_CHECK)
    idx = g.permutation(n_cells)[:min(n_check, n_cells)]
    if must is not None and must not in idx:
        idx[-1] = must
    return np.sort(idx)
