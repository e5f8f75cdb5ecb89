"""Markov-chain numerics (port of ``aiyagari_hark_tpu/ops/markov.py``):
the Tauchen discretization of the labor process and the stationary
distribution of a row-stochastic matrix.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


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
    squaring, each square renormalized by its row sums (reference
    precision only)."""
    if precision != "reference":
        raise NotImplementedError(
            f"precision={precision!r} is not ported yet: the precision "
            f"ladder is ROADMAP Queue 1 item 6")
    n = transition.shape[0]
    pi = torch.full((n,), 1.0 / n, dtype=transition.dtype,
                    device=transition.device)
    mat = transition
    for _ in range(max(1, math.ceil(math.log2(iters)))):
        mat = mat @ mat
        mat = mat / torch.sum(mat, dim=1, keepdim=True)
    pi = pi @ mat
    return pi / torch.sum(pi)
