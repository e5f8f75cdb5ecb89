"""The Table II calibration sweep as one batched solve (port of the locked
schedule of ``aiyagari_hark_tpu/parallel/sweep.run_table2_sweep``).

Every (sigma, rho, sd) cell is a lane of one lane-batched bisection
(``models.equilibrium.solve_equilibrium_lean``); each lane runs its own
bracket and exits at its own convergence, and the inner fixed points of
all active lanes run as one launch of each CUDA kernel per trip (of the
fused kernel alone under ``kernel="fused"``).  The
JAX engine's scheduler, quarantine ladder, resume ledger, integrity
rechecks and sharding are not ported (ROADMAP Queue 1 items 9, 10, 13):
a failed cell keeps its failing status and NaN values.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device, resolve_dtype
from ..models.equilibrium import solve_equilibrium_lean
from ..models.household import build_simple_model, stack_models
from ..solver_health import is_failure

_MODEL_KEYS = ("labor_states", "a_min", "a_max", "a_count", "a_nest_fac",
               "dist_count")


def sweep_cells(crra_values=(1.0, 3.0, 5.0), rho_values=(0.0, 0.3, 0.6, 0.9),
                labor_sd=0.2):
    """The (crra, rho, sd) cells of ``SweepConfig.cells()``: sd-major, then
    crra, then rho; ``labor_sd`` may be a tuple of panels."""
    sds = (tuple(float(s) for s in labor_sd)
           if isinstance(labor_sd, (tuple, list)) else (float(labor_sd),))
    return [(s, r, sd) for sd in sds for s in crra_values for r in rho_values]


@dataclass
class SweepResult:
    """Per-cell equilibrium objects, cell-major ([C] leading axis), host
    numpy.  ``excess`` mixes supply at the last bisection midpoint with
    demand at r*, so it is a residual accurate to O(r_tol).  A failed
    cell (``is_failure(status)``) has NaN ``r_star_pct`` and ``capital``
    and the values derived from them."""

    crra: np.ndarray
    labor_ar: np.ndarray
    labor_sd: np.ndarray
    r_star_pct: np.ndarray
    saving_rate_pct: np.ndarray
    capital: np.ndarray
    excess: np.ndarray
    bisect_iters: np.ndarray
    egm_iters: np.ndarray
    dist_iters: np.ndarray
    status: np.ndarray
    wall_seconds: float = float("nan")
    device: str = ""


def run_table2_sweep(cells=None, dtype=None, device=None,
                     **model_kwargs) -> SweepResult:
    """Solve every cell as one lane-batched equilibrium on ``device``
    (default: the card) in ``dtype`` (default float32).

    ``cells``: (crra, rho, sd) triples, default ``sweep_cells()`` (the 12
    Table II cells).  ``model_kwargs`` go to the model build
    (``a_count``, ``dist_count``, ...) and to the solver (``disc_fac``,
    ``cap_share``, ``depr_fac``, ``prod``, tolerances, ``kernel``);
    ``grid`` goes to both.

    ``wall_seconds`` covers the model build and the batched solve, and
    stops after the results reach the host."""
    dev = resolve_device(device)
    dt = resolve_dtype(dtype)
    cells = np.asarray(sweep_cells() if cells is None else cells,
                       dtype=np.float64)
    kw = dict(model_kwargs)
    build_kw = {k: kw.pop(k) for k in _MODEL_KEYS if k in kw}
    grid = kw.pop("grid", "reference")
    alpha = kw.pop("cap_share", 0.36)
    delta = kw.pop("depr_fac", 0.08)
    prod = kw.pop("prod", 1.0)
    beta = kw.pop("disc_fac", 0.96)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    model = stack_models([
        build_simple_model(labor_ar=float(rho), labor_sd=float(sd),
                           grid=grid, dtype=dt, device=dev, **build_kw)
        for _, rho, sd in cells])
    crra = torch.as_tensor(cells[:, 0], dtype=dt, device=dev)
    lean = solve_equilibrium_lean(model, beta, crra, alpha, delta, prod,
                                  grid=grid, **kw)
    host = {k: v.cpu().numpy() for k, v in lean._asdict().items()}
    wall = time.perf_counter() - t0

    status = host["status"].astype(np.int64)
    failed = is_failure(status)
    r = np.where(failed, np.nan, host["r_star"].astype(np.float64))
    K = np.where(failed, np.nan, host["capital"].astype(np.float64))
    L = host["labor"].astype(np.float64)
    # host-side closed forms (firm identities): demand from the inverted
    # marginal product of capital, Y from Cobb-Douglas, s = delta K / Y
    demand = ((r + delta) / (prod * alpha)) ** (1.0 / (alpha - 1.0)) * L
    output = prod * K ** alpha * L ** (1.0 - alpha)
    return SweepResult(
        crra=cells[:, 0], labor_ar=cells[:, 1], labor_sd=cells[:, 2],
        r_star_pct=r * 100.0, saving_rate_pct=delta * K / output * 100.0,
        capital=K, excess=K - demand,
        bisect_iters=host["bisect_iters"].astype(np.int64),
        egm_iters=host["egm_iters"].astype(np.int64),
        dist_iters=host["dist_iters"].astype(np.int64),
        status=status, wall_seconds=wall, device=str(dev))
