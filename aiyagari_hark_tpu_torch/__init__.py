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
with its checkpoint, resume and transient retry.
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
