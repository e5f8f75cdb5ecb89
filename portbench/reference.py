"""The plain reference of an Aiyagari cell, in PyTorch float64.

It rebuilds every derived object from the cell (crra, rho, sd) and the
configuration's numbers alone: the Tauchen chain and its stationary
labor distribution, the asset and histogram grids, the EGM policy at the
prices of a rate r, the Young lottery on the histogram support and its
stationary distribution.  It imports nothing of the program and takes
nothing the program made, except the answers it judges.

The model (the discretised Aiyagari economy the program solves):

    R = 1 + r,  K/L = ((r + delta) / (Z alpha))^(1 / (alpha - 1)),
    W = Z (1 - alpha) (K/L)^alpha
    EGM:  c(s, a_i) = (beta R sum_s' P[s, s'] c'(R a_i + W l_s')^-crra)
                      ^(-1/crra),
          m = a_i + c, the knot (b + eps, eps) first, linear interpolation
          with linear extrapolation past both ends
    lottery: a' = clip(m - c(m), b, x_max) on the histogram support x,
          split between its two neighbours, then the labor chain
    supply A(r) = sum x_d dist(d, s),  demand K(r) = (K/L)(r) E[l]

Where the program iterates, the reference solves otherwise: the policy
by plain EGM steps to a sup-norm of ``EGM_TOL`` (no extrapolation), the
distribution by a direct LU solve of the bordered stationary system with
iterative refinement, the labor distribution by a linear solve.

``evaluate`` (and ``judge``, which the harness calls) evaluates the
reference at each program r* and one step ``h`` above it, and returns how far that r* lies from the reference's root
(a Newton step on the excess supply, in basis points) and how far the
program's capital lies from the reference's supply at its r*.
"""

from __future__ import annotations

import math

import torch

# Sup-norm on the policy knots at which the reference's EGM iteration
# stops, and the cap on its steps.
EGM_TOL = 1e-12
EGM_MAX_STEPS = 40000
EGM_CHECK_EVERY = 64
# Rounds of iterative refinement after the LU solve of the distribution.
REFINE = 2


def exp_mult_grid(lo: float, hi: float, n: int, nest: int) -> torch.Tensor:
    """The multi-exponential grid on [lo, hi] with n points: the end points
    taken through x -> log(1 + x) ``nest`` times, spaced evenly there,
    and taken back (float64, on the host)."""
    a, b = float(lo), float(hi)
    for _ in range(nest):
        a, b = math.log1p(a), math.log1p(b)
    g = torch.linspace(a, b, n, dtype=torch.float64)
    for _ in range(nest):
        g = torch.expm1(g)
    return g


def tauchen(n: int, rho: float, sd: float, bound: float):
    """Tauchen (1986) chain of log labor with stationary s.d. ``sd``: the
    grid spans +-``bound`` stationary s.d., interior cells take the
    normal mass of their half-bins, the edge cells the tails.  Returns
    (levels [n] normalised to unit mean over the grid, P [n, n])."""
    sig = sd * math.sqrt(1.0 - rho * rho)
    y_max = bound * sig / math.sqrt(1.0 - rho * rho)
    y = torch.linspace(-y_max, y_max, n, dtype=torch.float64)
    half = (y[1] - y[0]) / 2.0
    mean = rho * y[:, None]
    cdf = torch.special.ndtr
    P = cdf((y[None, :] + half - mean) / sig) - cdf(
        (y[None, :] - half - mean) / sig)
    P[:, 0] = cdf((y[0] + half - mean[:, 0]) / sig)
    P[:, -1] = 1.0 - cdf((y[-1] - half - mean[:, 0]) / sig)
    lv = torch.exp(y)
    return lv / lv.mean(), P


def stationary_labor(P: torch.Tensor) -> torch.Tensor:
    """The stationary row vector of P by one linear solve:
    pi (I - P) = 0 with its last equation replaced by sum pi = 1."""
    n = P.shape[0]
    M = (torch.eye(n, dtype=P.dtype) - P).T.clone()
    M[-1, :] = 1.0
    rhs = torch.zeros(n, dtype=P.dtype)
    rhs[-1] = 1.0
    return torch.linalg.solve(M, rhs)


class Economy:
    """The lanes to evaluate: cell b's chain, crra and rate, and the grids
    of the configuration ``cfg`` (a dict of its numbers), on ``device``."""

    def __init__(self, cells, rates, cfg: dict, device):
        self.cfg = cfg
        self.dev = torch.device(device)
        f64 = dict(dtype=torch.float64, device=self.dev)
        N = int(cfg["labor_states"])
        b = float(cfg["borrow_limit"])
        span = float(cfg["a_max"]) - b
        nest = int(cfg["a_nest_fac"])
        self.a = (b + exp_mult_grid(cfg["a_min"], span, int(cfg["a_count"]),
                                    nest)).to(**f64)
        self.x = (b + torch.cat([torch.zeros(1, dtype=torch.float64),
                                 exp_mult_grid(cfg["a_min"], span,
                                               int(cfg["dist_count"]) - 1,
                                               nest)])).to(**f64)
        chains = [tauchen(N, float(rho), float(sd), float(cfg["labor_bound"]))
                  for _, rho, sd in cells]
        self.levels = torch.stack([c[0] for c in chains]).to(**f64)
        self.P = torch.stack([c[1] for c in chains]).to(**f64)
        pi = torch.stack([stationary_labor(c[1]) for c in chains])
        self.labor = (pi * torch.stack([c[0] for c in chains])).sum(1).to(
            **f64)
        self.crra = torch.tensor([float(c[0]) for c in cells], **f64)
        self.r = torch.as_tensor(rates, **f64)
        alpha, delta, Z = (float(cfg[k]) for k in
                           ("cap_share", "depr_fac", "prod"))
        self.k_to_l = ((self.r + delta) / (Z * alpha)) ** (1.0 / (alpha - 1.0))
        self.R = 1.0 + self.r
        self.W = Z * (1.0 - alpha) * self.k_to_l ** alpha


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor):
    """Each row of ``x`` [..., Q] linearly on its own knots ``xp``/``fp``
    [..., K], extrapolating along the end segments."""
    K = xp.shape[-1]
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x.contiguous(),
                                       right=True) - 1, 0, K - 2)
    x0, x1 = xp.gather(-1, i), xp.gather(-1, i + 1)
    f0, f1 = fp.gather(-1, i), fp.gather(-1, i + 1)
    return f0 + (f1 - f0) / (x1 - x0) * (x - x0)


def egm_policy(eco: Economy):
    """The EGM fixed point of every lane: knots (m, c) [B, N, A+1], the
    steps taken and the last sup-norm step."""
    cfg = eco.cfg
    beta = float(cfg["disc_fac"])
    b = float(cfg["borrow_limit"])
    eps = float(cfg["constraint_eps"])
    a = eco.a
    B, N = eco.levels.shape
    R, W = eco.R[:, None, None], eco.W[:, None, None]
    crra = eco.crra[:, None, None]
    m_next = R * a + W * eco.levels[:, :, None]               # [B, N', A]
    head = torch.full((B, N, 1), eps, dtype=a.dtype, device=a.device)
    m = torch.cat([head + b, (a + eps).expand(B, N, -1)], dim=-1)
    c = m - b
    steps, diff = 0, float("inf")
    while steps < EGM_MAX_STEPS:
        for _ in range(EGM_CHECK_EVERY):
            vp = interp(m_next, m, c) ** (-crra)
            c_now = (beta * R * (eco.P @ vp)) ** (-1.0 / crra)
            m_new = torch.cat([head + b, a + c_now], dim=-1)
            c_new = torch.cat([head, c_now], dim=-1)
            d = torch.maximum((m_new - m).abs().amax(),
                              (c_new - c).abs().amax())
            m, c = m_new, c_new
            steps += 1
        diff = float(d)
        if not math.isfinite(diff) or diff <= EGM_TOL:
            break
    return m, c, steps, diff


def stationary_distribution(eco: Economy, m: torch.Tensor, c: torch.Tensor):
    """Every lane's stationary distribution [B, D, N] under the policy
    knots (m, c), each by a direct solve, and the largest residual
    |A x - x| of the solves."""
    cfg = eco.cfg
    b = float(cfg["borrow_limit"])
    x = eco.x
    D = x.shape[0]
    B, N = eco.levels.shape
    wealth = (eco.R[:, None, None] * x[None, None, :]
              + eco.W[:, None, None] * eco.levels[:, :, None])   # [B, N, D]
    a_next = torch.clamp(wealth - interp(wealth, m, c), min=b,
                         max=float(x[-1]))
    i = torch.clamp(torch.searchsorted(x, a_next.contiguous(), right=True) - 1,
                    0, D - 2)
    w = torch.clamp((a_next - x[i]) / (x[i + 1] - x[i]), 0.0, 1.0)
    DN = D * N
    dev = x.device
    n_src = torch.arange(N, device=dev)[:, None].expand(N, D)
    d_src = torch.arange(D, device=dev)[None, :].expand(N, D)
    col = (d_src * N + n_src).reshape(-1)                     # source (d, n)
    rhs = torch.zeros((DN, 1), dtype=x.dtype, device=dev)
    rhs[-1] = 1.0
    dists, worst = [], 0.0
    for lane in range(B):
        A = torch.zeros((DN, DN), dtype=x.dtype, device=dev)
        for shift, share in ((0, 1.0 - w[lane]), (1, w[lane])):
            tgt_d = (i[lane] + shift).reshape(-1)
            for n2 in range(N):
                coef = (share * eco.P[lane][:, n2][:, None]).reshape(-1)
                A.index_put_((tgt_d * N + n2, col), coef, accumulate=True)
        M = -A
        M.diagonal().add_(1.0)
        M[-1, :] = 1.0
        lu, piv = torch.linalg.lu_factor(M)
        sol = torch.linalg.lu_solve(lu, piv, rhs)
        for _ in range(REFINE):
            sol = sol + torch.linalg.lu_solve(lu, piv, rhs - M @ sol)
        del M, lu
        sol = torch.clamp(sol[:, 0], min=0.0)
        sol = sol / sol.sum()
        worst = max(worst, float((A @ sol - sol).abs().max()))
        del A
        dists.append(sol.reshape(D, N))
    return torch.stack(dists), worst


def supply(eco: Economy):
    """Household capital supply A(r) of every lane, and diagnostics."""
    m, c, steps, egm_diff = egm_policy(eco)
    dist, resid = stationary_distribution(eco, m, c)
    K = (dist * eco.x[None, :, None]).sum(dim=(1, 2))
    return K, {"egm_steps": steps, "egm_diff": egm_diff,
               "dist_residual": resid}


def judge(cells, r_star, capital, cfg: dict, device) -> dict:
    """The numbers the harness compares, {"r_gap_bp": [M],
    "capital_rel": [M]}, as ``evaluate`` gives them."""
    return evaluate(cells, r_star, capital, cfg, device)[0]


def evaluate(cells, r_star, capital, cfg: dict, device, h: float = 1e-6):
    """Hold the program's answers for ``cells`` [M, 3] to the reference.

    Returns ({"r_gap_bp": [M], "capital_rel": [M]}, diagnostics): the distance
    from each r* to the root of the reference's excess supply, by a
    Newton step from the excess at r* and at r* + h (inf where the excess
    does not rise there), in basis points; and |capital - A(r*)| / A(r*)
    with the reference's supply A."""
    cells = [tuple(float(v) for v in c) for c in cells]
    r_star = [float(r) for r in r_star]
    rates = r_star + [r + h for r in r_star]
    eco = Economy(cells + cells, rates, cfg, device)
    K, diag = supply(eco)
    excess = K - eco.k_to_l * eco.labor
    M = len(cells)
    e0, e1 = excess[:M], excess[M:]
    rise = (e1 - e0) / h
    gap = torch.where(rise > 0, e0.abs() / rise,
                      torch.full_like(e0, float("inf")))
    cap = torch.as_tensor(capital, dtype=torch.float64, device=K.device)
    cap_rel = (cap - K[:M]).abs() / K[:M]
    gap = torch.nan_to_num(gap, nan=float("inf"))
    cap_rel = torch.nan_to_num(cap_rel, nan=float("inf"))
    return {"r_gap_bp": (gap * 1e4).cpu().tolist(),
            "capital_rel": cap_rel.cpu().tolist()}, diag
