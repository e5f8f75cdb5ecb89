"""Equilibrium serving subsystem (DESIGN §8; port of
``aiyagari_hark_tpu/serve``): micro-batched query engine over a
content-addressed solution store with nearest-neighbor warm starts.

The batch sweep (``parallel.sweep``) answers "solve this lattice once,
fast"; this package answers "serve equilibrium queries interactively" —
exact hits from the store in microseconds, near hits warm-started from
the nearest cached neighbor through the verified ``dyadic_bracket``
mechanism, cold misses micro-batched onto a fixed ladder of launch
shapes through the sweep's batched cell solver, so on the card every
cold or near flush runs the hand-written lane kernels.

The fleet tier runs N worker processes (``serve.fleet``: an HTTP front
over one service each, ``--device`` the card by default) over one shared
disk store, coordinated by shared-directory, loopback-CAS or replicated
quorum leases (``serve.replicated``), driven by the load harness
(``serve.loadgen``) and the chaos and disaster-recovery drills
(``serve.chaos``).  A multi-device ``mesh`` and ``state_shards > 1``
raise ``NotImplementedError`` (ROADMAP Queue 1 item 6).
"""

from .batcher import (  # noqa: F401
    MicroBatcher,
    ServeQueueFull,
    default_ladder,
    shard_ladder,
)
from .cellindex import (  # noqa: F401
    CellIndex,
    linear_nearest_k,
)
from .chaos import (  # noqa: F401
    ChaosAgent,
    ChaosPlan,
    DrillError,
    run_drills,
)
from .fleet import (  # noqa: F401
    FleetClient,
    FleetFront,
    FleetHTTPError,
    HedgePolicy,
    RetryPolicy,
    error_to_json,
    result_to_json,
    worker_main,
)
from .lease import (  # noqa: F401
    CASServer,
    LeaseBackend,
    LoopbackCASBackend,
    MemoryCASBackend,
    SharedDirBackend,
    make_backend,
)
from .loadgen import (  # noqa: F401
    Arrival,
    FleetCtl,
    FleetReport,
    FleetSpec,
    LoadReport,
    LoadSpec,
    ManualClock,
    generate_arrivals,
    generate_fleet_arrivals,
    run_fleet_load,
    run_load,
)
from .metrics import ServeMetrics  # noqa: F401
from .overload import (  # noqa: F401
    AdmissionPolicy,
    CircuitBreaker,
    Priority,
    predicted_work,
    priority_name,
)
from .service import (  # noqa: F401
    CertificationFailed,
    CircuitOpen,
    DeadlineExceeded,
    EquilibriumQuery,
    EquilibriumService,
    EquilibriumSolveFailed,
    LoadShed,
    Overloaded,
    ServedResult,
    ServeError,
    ServiceClosed,
    make_query,
)
from .store import (  # noqa: F401
    UNCERTIFIED,
    Donation,
    SolutionStore,
    StoredSolution,
    make_solution,
)
from .surrogate import (  # noqa: F401
    SurrogateFit,
    SurrogatePolicy,
    fit_surrogate,
)
