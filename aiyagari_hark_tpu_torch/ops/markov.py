"""Markov-chain numerics (port of ``aiyagari_hark_tpu/ops/markov.py``):
the Tauchen discretization of the labor process, the stationary
distribution of a row-stochastic matrix (under the three precision
policies), and the Krusell-Smith aggregate, employment and composite
transition matrices.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils.config import resolve_precision


class TauchenResult(NamedTuple):
    """Grid of (log-)states and row-stochastic transition matrix."""

    grid: torch.Tensor        # [n] equally spaced points in the log state
    transition: torch.Tensor  # [n, n]; transition[j, k] = P(next=k | cur=j)


def _linspace(start: torch.Tensor, stop: torch.Tensor, n: int) -> torch.Tensor:
    """``start (1 - s) + stop s`` for ``s = k / (n-1)``, last point exactly
    ``stop`` -- the rounding of the JAX package's ``jnp.linspace``."""
    s = (torch.arange(n - 1, dtype=start.dtype, device=start.device)
         / (n - 1))
    return torch.cat([start * (1 - s) + stop * s, stop.reshape(1)])


def tauchen_ar1(n: int, sigma: float, ar_1: float, bound: float = 3.0,
                dtype=torch.float32, device="cpu") -> TauchenResult:
    """Tauchen (1986) discretization of ``y' = ar_1 * y + sigma * eps``
    (HARK's ``make_tauchen_ar1``): the grid spans ``± bound`` stationary
    standard deviations, interior masses are normal CDF differences over
    half-bin widths, and the edge columns absorb the tails."""
    if n == 1:
        return TauchenResult(
            grid=torch.zeros((1,), dtype=dtype, device=device),
            transition=torch.ones((1, 1), dtype=dtype, device=device))
    ndtr = torch.special.ndtr
    sigma = torch.as_tensor(sigma, dtype=dtype, device=device)
    ar_1 = torch.as_tensor(ar_1, dtype=dtype, device=device)
    y_max = bound * sigma / torch.sqrt(1.0 - ar_1 ** 2)
    grid = _linspace(-y_max, y_max, n)
    step = grid[1] - grid[0]
    cond_mean = ar_1 * grid[:, None]
    upper = ndtr((grid[None, :] + step / 2.0 - cond_mean) / sigma)
    lower = ndtr((grid[None, :] - step / 2.0 - cond_mean) / sigma)
    probs = upper - lower
    probs[:, 0] = ndtr((grid[0] + step / 2.0 - cond_mean[:, 0]) / sigma)
    probs[:, -1] = 1.0 - ndtr((grid[-1] - step / 2.0 - cond_mean[:, 0])
                              / sigma)
    return TauchenResult(grid=grid, transition=probs)


def tauchen_labor_process(n_states: int, labor_ar: float, labor_sd: float,
                          bound: float = 3.0, dtype=torch.float32,
                          device="cpu") -> TauchenResult:
    """AR(1) in logs with *stationary* s.d. ``labor_sd``: the innovation
    s.d. is ``labor_sd * sqrt(1 - ar^2)``."""
    sigma_innov = labor_sd * (1.0 - labor_ar ** 2) ** 0.5
    return tauchen_ar1(n_states, sigma_innov, labor_ar, bound=bound,
                       dtype=dtype, device=device)


def normalized_labor_states(tauchen_grid: torch.Tensor) -> torch.Tensor:
    """Labor levels ``exp(grid) / mean(exp(grid))`` (the reference
    normalizes by the unweighted mean over gridpoints)."""
    levels = torch.exp(tauchen_grid)
    return levels / torch.mean(levels)


def stationary_distribution(transition: torch.Tensor, iters: int = 2000,
                            precision: str = "reference") -> torch.Tensor:
    """Stationary row vector of a row-stochastic matrix by repeated
    squaring, each square renormalized by its row sums.

    ``precision``: "reference" and "mixed" square in the matrix's dtype
    ("mixed" equals "reference": a handful of [n, n] products has nothing
    to save, and no affordable polish repairs cheap squaring on a
    persistent chain).  "fast" squares in the cheap dtype (float32 for a
    float64 matrix, in plain float32 arithmetic: the port never enables
    TF32), then polishes with 8 power steps against the matrix in its own
    dtype -- approximate, as the JAX package's "fast" is."""
    spec = resolve_precision(precision)
    cheap = spec.two_phase and not spec.polish
    ref_dt = transition.dtype
    n = transition.shape[0]
    mat = transition
    if cheap and ref_dt == torch.float64:
        mat = transition.to(torch.float32)
    pi = torch.full((n,), 1.0 / n, dtype=mat.dtype, device=mat.device)
    for _ in range(max(1, math.ceil(math.log2(iters)))):
        mat = mat @ mat
        mat = mat / torch.sum(mat, dim=1, keepdim=True)
    pi = pi @ mat
    pi = (pi / torch.sum(pi)).to(ref_dt)
    if cheap:
        for _ in range(8):
            pi = pi @ transition
            pi = pi / torch.sum(pi)
    return pi


_NP_DTYPES = {torch.float64: np.float64, torch.float32: np.float32}


def aggregate_markov_matrix(dur_mean_b: float, dur_mean_g: float,
                            dtype=torch.float32, device="cpu") -> torch.Tensor:
    """2x2 aggregate (Bad/Good) transition matrix from mean state
    durations (``Aiyagari_Support.py:1647-1651``): exit probability =
    1 / duration."""
    prob_bg = 1.0 / dur_mean_b
    prob_gb = 1.0 / dur_mean_g
    return torch.tensor([[1.0 - prob_bg, prob_bg],
                         [prob_gb, 1.0 - prob_gb]], dtype=dtype,
                        device=device)


def employment_markov_matrix(dur_mean_b: float, dur_mean_g: float,
                             spell_mean_b: float, spell_mean_g: float,
                             urate_b: float, urate_g: float,
                             rel_prob_bg: float, rel_prob_gb: float,
                             dtype=torch.float32,
                             device="cpu") -> torch.Tensor:
    """4x4 joint (aggregate x employment) transition matrix, the
    Krusell-Smith calibration identities (``Aiyagari_Support.py:1655-1683``).

    Row/column order: (Bad-Unemp, Bad-Emp, Good-Unemp, Good-Emp).  The
    entries are set one after another in the matrix's dtype, each later
    one reading the stored (rounded) earlier ones, as the JAX package's
    ``.at[].set`` sequence does."""
    prob_bg = 1.0 / dur_mean_b
    prob_gb = 1.0 / dur_mean_g
    prob_bb = 1.0 - prob_bg
    prob_gg = 1.0 - prob_gb

    m = np.zeros((4, 4), dtype=_NP_DTYPES[dtype])
    # Bad -> Bad quadrant: leave unemployment with prob 1/spell length.
    m[0, 1] = prob_bb / spell_mean_b
    m[0, 0] = prob_bb * (1.0 - 1.0 / spell_mean_b)
    m[1, 0] = urate_b / (1.0 - urate_b) * m[0, 1]
    m[1, 1] = prob_bb - m[1, 0]
    # Good -> Good quadrant.
    m[2, 3] = prob_gg / spell_mean_g
    m[2, 2] = prob_gg * (1.0 - 1.0 / spell_mean_g)
    m[3, 2] = urate_g / (1.0 - urate_g) * m[2, 3]
    m[3, 3] = prob_gg - m[3, 2]
    # Bad -> Good quadrant.
    m[0, 2] = rel_prob_bg * m[2, 2] / prob_gg * prob_bg
    m[0, 3] = prob_bg - m[0, 2]
    m[1, 2] = (prob_bg * urate_g - urate_b * m[0, 2]) / (1.0 - urate_b)
    m[1, 3] = prob_bg - m[1, 2]
    # Good -> Bad quadrant.
    m[2, 0] = rel_prob_gb * m[0, 0] / prob_bb * prob_gb
    m[2, 1] = prob_gb - m[2, 0]
    m[3, 0] = (prob_gb * urate_b - urate_g * m[2, 0]) / (1.0 - urate_g)
    m[3, 1] = prob_gb - m[3, 0]
    return torch.as_tensor(m, device=device)


def full_idiosyncratic_matrix(tauchen_transition: torch.Tensor,
                              employment_matrix: torch.Tensor) -> torch.Tensor:
    """[4N, 4N] composite transition matrix ``kron(P_tauchen, P_empl)``:
    labor-state-major, employment-minor ordering (the reference's 49
    literal AuxMatrix blocks, ``Aiyagari_Support.py:1712-1780``)."""
    return torch.kron(tauchen_transition, employment_matrix)
