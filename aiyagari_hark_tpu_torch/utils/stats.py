"""Wealth-distribution analytics: weighted percentiles, Lorenz curves, Gini,
and the notebook's SCF-comparison measures (the port's copy of
``aiyagari_hark_tpu/utils/stats.py``, NumPy only; it reads its own copy of
the vendored SCF curve, ``aiyagari_hark_tpu_torch/data/scf_lorenz.csv``).

The reference pulls these from HARK (``get_lorenz_shares``/``get_percentiles``
at ``Aiyagari-HARK.py:299``, SCF data via ``load_SCF_wealth_weights`` at
``:303``) and computes a Euclidean Lorenz distance (``:332-333``).  These are
host-side post-processing, so they are plain NumPy: the device path ends at
the simulated panel / histogram.
"""

from __future__ import annotations

import csv
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np

DEFAULT_PCTILES = np.linspace(0.01, 0.999, 15)   # Aiyagari-HARK.py:312


def _sorted_weighted(data, weights, presorted: bool = False):
    data = np.asarray(data, dtype=np.float64).ravel()
    if weights is None:
        weights = np.ones_like(data)
    else:
        weights = np.asarray(weights, dtype=np.float64).ravel()
    if presorted:
        return data, weights
    order = np.argsort(data)
    return data[order], weights[order]


def get_percentiles(data, weights=None,
                    percentiles=(0.5,), presorted: bool = False):
    """Weighted empirical quantiles, HARK ``get_percentiles`` semantics:
    linear interpolation of the sorted data against the plain normalized
    cumulative weights (no midpoint shift — e.g. [1,2,3,4] at p=0.5 gives
    2.0, matching HARK, not the midpoint variant's 2.5)."""
    d, w = _sorted_weighted(data, weights, presorted)
    cum = np.cumsum(w) / np.sum(w)
    return np.interp(np.asarray(percentiles), cum, d)


def get_lorenz_shares(data, weights=None, percentiles=None,
                      presorted: bool = False) -> np.ndarray:
    """Cumulative wealth share held below each population percentile — the
    Lorenz curve sampled at ``percentiles`` (HARK ``get_lorenz_shares``)."""
    if percentiles is None:
        percentiles = DEFAULT_PCTILES
    d, w = _sorted_weighted(data, weights, presorted)
    cum_pop = np.cumsum(w) / np.sum(w)
    cum_wealth = np.cumsum(d * w)
    cum_wealth = cum_wealth / cum_wealth[-1]
    return np.interp(np.asarray(percentiles), cum_pop, cum_wealth)


def lorenz_distance(data_a, data_b, weights_a=None, weights_b=None,
                    percentiles=None) -> float:
    """Euclidean distance between two Lorenz curves on a percentile grid —
    the notebook's simulated-vs-SCF measure (``Aiyagari-HARK.py:332-333``)."""
    la = get_lorenz_shares(data_a, weights_a, percentiles)
    lb = get_lorenz_shares(data_b, weights_b, percentiles)
    return float(np.sqrt(np.sum((la - lb) ** 2)))


def gini(data, weights=None) -> float:
    """Gini coefficient of a (weighted) sample: 1 - 2 * area under Lorenz."""
    d, w = _sorted_weighted(data, weights)
    cum_pop = np.concatenate([[0.0], np.cumsum(w) / np.sum(w)])
    cw = np.cumsum(d * w)
    cum_wealth = np.concatenate([[0.0], cw / cw[-1]])
    area = np.trapezoid(cum_wealth, cum_pop)
    return float(1.0 - 2.0 * area)


class WealthStats(NamedTuple):
    """The notebook's simulated-wealth readout (cell 24 output; BASELINE.md
    reference values 22.046 / 5.439 / 3.697 / 4.718)."""

    max: float
    mean: float
    std: float
    median: float


def wealth_stats(assets, weights=None) -> WealthStats:
    a = np.asarray(assets, dtype=np.float64).ravel()
    if weights is None:
        return WealthStats(max=float(a.max()), mean=float(a.mean()),
                           std=float(a.std()), median=float(np.median(a)))
    w = np.asarray(weights, dtype=np.float64).ravel()
    mean = float(np.average(a, weights=w))
    var = float(np.average((a - mean) ** 2, weights=w))
    # max over the OCCUPIED support: histogram inputs carry zero-weight
    # grid nodes above the ergodic right tail
    occupied = a[w > 1e-12 * w.sum()]
    return WealthStats(max=float(occupied.max()), mean=mean, std=var ** 0.5,
                       median=float(get_percentiles(a, w, (0.5,))[0]))


def histogram_sample(dist_grid, masses) -> Tuple[np.ndarray, np.ndarray]:
    """Flatten a stationary histogram ``[D, N]`` (or ``[D]``) over the wealth
    grid into a (values, weights) pair for the analytics above — the
    deterministic replacement for the reference's simulated agent panel."""
    g = np.asarray(dist_grid, dtype=np.float64)
    m = np.asarray(masses, dtype=np.float64)
    if m.ndim == 2:
        m = m.sum(axis=1)
    return g, m


class SCFLorenz(NamedTuple):
    """The SCF Lorenz curve at the notebook's 15-point percentile grid, plus
    the reference's own simulated curve from the same figure (useful as an
    extraction self-check: their distance reproduces the 0.9714 golden)."""

    pctiles: np.ndarray
    scf_shares: np.ndarray
    ref_sim_shares: np.ndarray


_SCF_LORENZ_CSV = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "data", "scf_lorenz.csv")


def load_scf_lorenz(path: Optional[str] = None) -> SCFLorenz:
    """SCF Lorenz shares at ``DEFAULT_PCTILES``, vendored from the
    reference's committed vector figure.

    The reference computes these from HARK's bundled SCF sample
    (``Aiyagari-HARK.py:303,313``); that dataset is unavailable here, so the
    curve was recovered from the path data of the reference's committed
    ``Figures/wealth_distribution_1.svg`` (a matplotlib vector figure; see
    ``scripts/extract_scf_lorenz.py`` for the method and its built-in
    verification against the printed 0.9714 golden).  Good to ~1e-5 per
    share — the Lorenz *distance* computation only ever needs the curve at
    this grid, not the raw microdata.
    """
    path = path or _SCF_LORENZ_CSV
    rows = []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#") or row[0] == "pctile":
                continue
            rows.append([float(v) for v in row[:3]])
    arr = np.asarray(rows, dtype=np.float64)
    return SCFLorenz(pctiles=arr[:, 0], scf_shares=arr[:, 1],
                     ref_sim_shares=arr[:, 2])


def lorenz_distance_vs_scf(sim_wealth, sim_weights=None,
                           path: Optional[str] = None) -> float:
    """The notebook's headline inequality measure: Euclidean distance
    between the simulated wealth Lorenz curve and the SCF curve on the
    15-point percentile grid (``Aiyagari-HARK.py:332-333``; reference
    golden 0.9714)."""
    scf = load_scf_lorenz(path)
    sim = get_lorenz_shares(sim_wealth, weights=sim_weights,
                            percentiles=scf.pctiles)
    return float(np.sqrt(np.sum((scf.scf_shares - sim) ** 2)))


def synthetic_scf_wealth(n: int = 20000,
                         seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic synthetic stand-in for the SCF wealth sample, so the
    Lorenz-comparison code path is exercisable without the real data (which
    the reference gets from HARK's bundled dataset,
    ``load_SCF_wealth_weights``, ``Aiyagari-HARK.py:303`` — unavailable
    here: no network, HARK not vendored).

    NOT the real SCF: a lognormal with sigma=1.9, whose Gini (~0.82)
    matches the well-known top-heaviness of U.S. net worth.  Any distance
    computed against it is a smoke value, not the reference's 0.9714
    golden — ``reproduce.py`` labels it accordingly.
    """
    rng = np.random.default_rng(seed)
    wealth = rng.lognormal(mean=0.0, sigma=1.9, size=n)
    weights = np.ones(n)
    return wealth, weights


def load_scf_wealth_weights(path: Optional[str] = None
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """U.S. Survey of Consumer Finances wealth observations + sample weights.

    The reference loads these from HARK's bundled dataset
    (``load_SCF_wealth_weights``, ``Aiyagari-HARK.py:303``); that package
    (and network access) is unavailable here, so this reads a two-column CSV
    ``wealth,weight`` supplied by the user (or ``$SCF_WEALTH_CSV``).
    """
    path = path or os.environ.get("SCF_WEALTH_CSV")
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            "SCF wealth data not bundled (no network in this build). Export "
            "it from HARK.datasets.load_SCF_wealth_weights() to a csv with "
            "columns wealth,weight and pass its path (or set "
            "$SCF_WEALTH_CSV).")
    wealth, weights = [], []
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if not row:
                continue
            try:
                v = float(row[0])
            except ValueError:   # header or comment line
                continue
            wealth.append(v)
            weights.append(float(row[1]) if len(row) > 1 else 1.0)
    if not wealth:
        raise ValueError(f"no numeric wealth rows parsed from {path}")
    return np.asarray(wealth), np.asarray(weights)
