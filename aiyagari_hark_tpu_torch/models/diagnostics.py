"""Solution-accuracy diagnostics for the Krusell-Smith equilibrium (port
of ``aiyagari_hark_tpu/models/diagnostics.py``).

den Haan (2010, JEDC, "Assessing the accuracy of the aggregate law of
motion"): iterate the perceived law on its own output along the realized
aggregate-shock path, with no feedback from the simulation, and report
the maximum and mean percent error against the simulated aggregates.  A
KS solution is accepted as accurate when the max error over a long
simulation is a fraction of a percent.  At the aggregate-degenerate
notebook calibration the slope-pinned histogram engine meets that bar
(its rule is a constant); the Monte-Carlo panel rule, whose slope is
attenuated by sampling noise, does not (``results.json``: max 2.28 % /
mean 0.42 % against 0.43 % / 0.13 % for the pinned engine, JAX on the
CPU).

The forecast is a scalar recursion of ~T steps: it runs on the host
(the calibration's scalars copied to CPU tensors), through the same
``mill_aggregates`` as the simulators.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ks_model import AFuncParams, KSCalibration


class DenHaanStats(NamedTuple):
    """Dynamic-forecast accuracy of the perceived aggregate law."""

    max_error_pct: torch.Tensor    # max |log Â - log A| x 100
    mean_error_pct: torch.Tensor   # mean |log Â - log A| x 100
    forecast: torch.Tensor         # [T'] the dynamic forecast path Â_t


def _on_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple):
        return type(x)(*(_on_cpu(f) for f in x))
    return x


def den_haan_forecast(sol, t_start: int | None = None) -> DenHaanStats:
    """Iterate the converged rule on its own output along the realized
    shock path, starting from the simulated aggregate at ``t_start``
    (default T//8; pass the solve's discard window to score exactly the
    regression's sample).  Timing matches the simulators and
    ``calc_afunc_update``: ``A_t = f_{z_{t-1}}(M_{t-1})`` and ``M_t =
    mill(A_t, z_t)``.  Returns CPU tensors."""
    from .simulate import mill_aggregates

    cal = KSCalibration(*(_on_cpu(f) for f in sol.calibration))
    afunc = AFuncParams(*(f.cpu() for f in sol.afunc))
    a_prev = sol.history.A_prev.cpu()
    mrkv = torch.as_tensor(sol.mrkv_hist).cpu().to(torch.int64)
    if t_start is None:
        t_start = max(1, a_prev.shape[0] // 8)
    m_hat = mill_aggregates(cal, a_prev[t_start], mrkv[t_start])[2]
    forecast = []
    for t in range(t_start + 1, a_prev.shape[0]):
        a_hat = afunc(m_hat, mrkv[t - 1])   # the one perceived-law function
        forecast.append(a_hat)
        m_hat = mill_aggregates(cal, a_hat, mrkv[t])[2]
    a_hat = torch.stack(forecast)
    log_err = torch.abs(torch.log(a_hat) - torch.log(a_prev[t_start + 1:]))
    log_err = log_err * 100.0
    return DenHaanStats(max_error_pct=torch.max(log_err),
                        mean_error_pct=torch.sum(log_err) / log_err.shape[0],
                        forecast=a_hat)
