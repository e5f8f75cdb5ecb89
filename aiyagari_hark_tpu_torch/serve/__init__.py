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

Not ported yet (ROADMAP Queue 1 item 8d): the fleet front and workers,
the replicated quorum backend, the chaos drills and the load harness
(``serve.{fleet,replicated,chaos,loadgen}``).  A multi-device ``mesh``
and ``state_shards > 1`` raise ``NotImplementedError`` (item 6).
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
from .lease import (  # noqa: F401
    CASServer,
    LeaseBackend,
    LoopbackCASBackend,
    MemoryCASBackend,
    SharedDirBackend,
    make_backend,
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
