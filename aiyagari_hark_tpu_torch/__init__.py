"""PyTorch and CUDA port of the Aiyagari heterogeneous-agent framework.

The JAX package ``aiyagari_hark_tpu`` is the reference; this package
mirrors its layout (``ops``, ``models``, ``parallel``, ``scenarios``,
``verify``, ``utils``, ``facade``) and keeps its array layouts.  Entry
points run on the CUDA card unless called with ``device="cpu"``.  The two
inner fixed points of the Table II equilibrium run in hand-written CUDA
kernels (``ops/csrc``, ``ops/kernels.py``): one kernel each, or both in
one launch under ``kernel="fused"``.  The sweep engine
(``parallel.sweep``) schedules, quarantines, rechecks and certifies the
cells of a ``utils.config.SweepConfig`` on one device.  The notebook's
Krusell-Smith path (``facade.AiyagariEconomy``, ``models.ks_solver``)
runs the panel and histogram simulators in plain PyTorch on the card,
with its checkpoint, resume and transient retry.  The model extensions
(``models.transition``, ``jacobian``, ``value``, ``heterogeneity``,
``fiscal``, ``labor``, ``calibrate``, ``lifecycle`` and the Huggett
credit crunch) run their path loops in plain PyTorch and their
stationary solves through the same kernels; so does the two-asset
portfolio economy (``models.portfolio``), whose push-forward is a
segmented sum without atomics.  The sweep engine keeps a resume ledger,
a scheduler sidecar and a transient retry around its launches.
"""

from .facade import (  # noqa: F401
    AggregateSavingRule,
    AiyagariEconomy,
    AiyagariSolution,
    AiyagariType,
    StatePolicy,
    init_aiyagari_agents,
    init_aiyagari_economy,
    quantile_resample,
)
from .models.calibrate import (  # noqa: F401
    CalibrationResult,
    LorenzFit,
    calibrate_beta_spread,
    calibrate_discount_factor,
    calibrate_labor_weight,
    calibrate_spread_to_lorenz,
)
from .models.fiscal import (  # noqa: F401
    FiscalEquilibrium,
    TaxSweepResult,
    build_fiscal_model,
    progressive_labor_levels,
    redistributive_labor_levels,
    solve_fiscal_equilibrium,
    tax_rate_sweep,
)
from .models.heterogeneity import (  # noqa: F401
    HeterogeneousEquilibrium,
    population_distribution,
    solve_heterogeneous_equilibrium,
    uniform_beta_types,
)
from .models.huggett import (  # noqa: F401
    CreditCrunchResult,
    HuggettEquilibrium,
    solve_credit_crunch,
    solve_huggett_equilibrium,
)
from .models.jacobian import (  # noqa: F401
    BusinessCycleMoments,
    HouseholdJacobians,
    LaborSequenceJacobians,
    LinearIRF,
    SequenceJacobians,
    ShockFit,
    business_cycle_moments,
    fit_shock_process,
    household_jacobians,
    innovation_irf,
    labor_business_cycle_moments,
    labor_sequence_jacobians,
    linear_impulse_response,
    sequence_jacobians,
    simulate_linear,
)
from .models.labor import (  # noqa: F401
    LaborEquilibrium,
    LaborTransitionResult,
    build_labor_model,
    solve_labor_equilibrium,
    solve_labor_household,
    solve_labor_transition,
)
from .models.lifecycle import (  # noqa: F401
    simulate_cohort,
    solve_lifecycle,
)
from .models.portfolio import (  # noqa: F401
    build_portfolio_model,
    solve_portfolio_equilibrium,
    solve_portfolio_household,
)
from .models.transition import (  # noqa: F401
    TransitionResult,
    TransitionWelfare,
    household_path_response,
    path_policies,
    solve_transition,
    transition_welfare,
)
from .models.value import (  # noqa: F401
    aggregate_welfare,
    consumption_equivalent,
    marginal_value_at,
    policy_value,
    value_at,
)
