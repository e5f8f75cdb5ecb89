"""Solution integrity (port of ``aiyagari_hark_tpu/verify``): a
posteriori certification of solved equilibria (``certificate``) and the
corruption drills (``inject``) of the sweep's SDC recheck, its resume
ledger, certification and the serving tier's solution store."""

from .certificate import (  # noqa: F401
    CERT_CHECKS,
    CERT_LEVEL_NAMES,
    CERTIFIED,
    FAILED,
    MARGINAL,
    UNCERTIFIED,
    Certificate,
    CertThresholds,
    CheckResult,
    cert_level_name,
    certify_equilibrium,
    certify_packed_rows,
    euler_residual_midpoints,
    lorenz_residual,
    shape_residual,
    stationarity_residuals,
)
from .inject import (  # noqa: F401
    corrupt_ledger_row,
    corrupt_store_entry,
    flip_row_bit,
    perturb_row,
    perturbed_policy,
)
