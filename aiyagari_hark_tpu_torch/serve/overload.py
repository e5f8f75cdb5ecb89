"""Overload management primitives for the serving engine (DESIGN §11;
port of ``aiyagari_hark_tpu/serve/overload.py``, host code, copied):
priority classes, predicted-work weights, and the regional circuit
breaker.

The serving layer types every other failure family — numerical,
preemption, corruption, per-query deadlines — but saturation used to be an untyped state: a full ``MicroBatcher`` either
blocked the caller or raised a bare ``ServeQueueFull``, every query was
equal priority, and a region of (σ, ρ, sd)-space whose cells repeatedly
failed was re-attempted at full cost forever.  This module holds the
host-side mechanics the ``EquilibriumService`` composes into typed
overload behavior (the knobs ride ``utils.config.AdmissionPolicy``):

* ``Priority`` — the query classes, most to least important.  Admission
  budgets are nested per class and shedding displaces strictly-lower
  classes only, so background sweep traffic can never starve an
  interactive caller.
* ``predicted_work`` — queue slots are weighted by predicted solve work
  (the sweep scheduler's cost model, ``heuristic_cell_work``), so ten
  cheap high-ρ cells and ten slow-mixing ρ=0 cells occupy the queue
  honestly rather than as "ten slots" each.
* ``CircuitBreaker`` — per-region (quantized (σ, ρ, sd) neighborhood
  within a solver group) failure breaker: open after K failures
  (``CircuitOpen`` fast-fail at submit), half-open probe on a
  deterministic cooldown schedule (doubling per reopen, capped), close
  on a certified success.  Purely host-side state driven by the
  service's injected clock — no wall-time reads, so breaker behavior is
  property-testable and replayable with a fake clock.

Host code: nothing here touches device state.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Tuple

import numpy as np

from ..utils.config import AdmissionPolicy  # noqa: F401  (re-export)


class Priority:
    """Query priority classes, most (0) to least (2) important.

    Plain ints so they ride ``EquilibriumQuery`` (a NamedTuple hashed by
    fingerprints) without enum baggage; ``priority`` never enters the
    solution fingerprint — two queries for the same calibration at
    different priorities address the same cached answer."""

    INTERACTIVE = 0
    BATCH = 1
    SPECULATIVE = 2


PRIORITY_NAMES = ("INTERACTIVE", "BATCH", "SPECULATIVE")
N_PRIORITIES = len(PRIORITY_NAMES)


def priority_name(p: int) -> str:
    p = int(p)
    if 0 <= p < N_PRIORITIES:
        return PRIORITY_NAMES[p]
    return f"UNKNOWN({p})"


def predicted_work(cell, scenario: str = "aiyagari") -> float:
    """Predicted relative solve work for one cell — the sweep scheduler's
    cold-start cost model, supplied per model family by the scenario's
    ``CellSpace.work``, reused as the admission layer's
    queue-slot weight so occupancy is measured in work, not request
    count."""
    from ..scenarios.registry import get_scenario

    work = get_scenario(scenario).cells.work
    return float(work(np.asarray([cell]))[0])


class _RegionState:
    """Mutable per-region breaker state (lock held by the breaker)."""

    __slots__ = ("state", "failures", "opened_at", "reopens", "probing")

    def __init__(self):
        self.state = "closed"
        self.failures = 0
        self.opened_at = 0.0
        self.reopens = 0
        self.probing = False


class CircuitBreaker:
    """Per-region circuit breaker over the serving cold path.

    A *region* is a quantized (σ, ρ, sd) neighborhood within one solver
    group (``region_key``): the observation that certification and
    NONFINITE failures cluster in parameter space (bracket-edge loss of
    contraction, slow-mixing corners) means one bad cell predicts its
    neighbors — so after ``failures`` consecutive failures the whole
    region fast-fails typed instead of burning a full solve per retry.

    State machine (all transitions returned to the caller so the service
    can journal them — this class stays observability-free):

    * CLOSED — normal; a success resets the failure count.
    * OPEN — every ``admit`` returns ``"open"`` (the service raises the
      typed ``CircuitOpen``) until the cooldown elapses.  The cooldown
      doubles per reopen up to ``backoff_cap`` x — a deterministic
      schedule, driven entirely by the ``now`` values the caller passes
      (the service's injected clock).
    * HALF-OPEN — the first ``admit`` at/after the cooldown returns
      ``"probe"`` exactly once: that query is admitted as the probe
      while everything else keeps fast-failing.  A certified success
      closes the region (full reset); a failure reopens it with the
      next backoff step; an aborted probe (shed, expired, drained)
      returns the region to plain OPEN so the next due ``admit`` can
      probe again.

    Thread-safe; every method is O(1) per region.
    """

    def __init__(self, failures: int = 3, cooldown_s: float = 1.0,
                 backoff_cap: int = 8,
                 region_scale: Tuple[float, float, float] = (2.0, 0.3, 0.1)):
        if failures < 1:
            raise ValueError(f"failures must be >= 1, got {failures}")
        self.failures = int(failures)
        self.cooldown_s = float(cooldown_s)
        self.backoff_cap = max(1, int(backoff_cap))
        self.region_scale = tuple(float(s) for s in region_scale)
        self._lock = threading.Lock()
        self._regions: dict = {}
        self._transitions: List[tuple] = []

    @classmethod
    def from_policy(cls, policy: AdmissionPolicy) -> "CircuitBreaker":
        return cls(failures=policy.breaker_failures,
                   cooldown_s=policy.breaker_cooldown_s,
                   backoff_cap=policy.breaker_backoff_cap,
                   region_scale=policy.breaker_region_scale)

    def region_key(self, cell, group: int) -> tuple:
        """Quantize a cell into its breaker region: the solver group plus
        each axis rounded to the region scale — neighbors in the same
        quantization bucket share one breaker."""
        return (int(group),) + tuple(
            int(round(float(c) / s))
            for c, s in zip(cell, self.region_scale))

    def _cooldown(self, st: _RegionState) -> float:
        return self.cooldown_s * min(2 ** st.reopens, self.backoff_cap)

    def _log(self, now: float, region: tuple, what: str) -> None:
        self._transitions.append((float(now), region, what))

    # -- admission ---------------------------------------------------------

    def admit(self, region: tuple, now: float) -> str:
        """Gate one arrival: ``"ok"`` (closed region), ``"open"``
        (fast-fail), or ``"probe"`` (admitted as the half-open probe)."""
        with self._lock:
            st = self._regions.get(region)
            if st is None or st.state == "closed":
                return "ok"
            if st.probing:
                return "open"
            if now >= st.opened_at + self._cooldown(st):
                st.probing = True
                self._log(now, region, "probe")
                return "probe"
            return "open"

    def retry_after(self, region: tuple, now: float) -> float:
        """Clock units until the region's next probe window (0.0 for a
        closed region) — the ``CircuitOpen`` retry-after payload."""
        with self._lock:
            st = self._regions.get(region)
            if st is None or st.state == "closed":
                return 0.0
            return max(0.0, st.opened_at + self._cooldown(st) - now)

    # -- outcome hooks -----------------------------------------------------

    def record_failure(self, region: tuple, now: float) -> Optional[str]:
        """One solve/certification failure in the region.  Returns the
        transition (``"opened"`` / ``"reopened"``) or None."""
        with self._lock:
            st = self._regions.setdefault(region, _RegionState())
            if st.probing:
                st.probing = False
                st.state = "open"
                st.opened_at = now
                st.reopens += 1
                self._log(now, region, "reopened")
                return "reopened"
            if st.state == "open":
                return None
            st.failures += 1
            if st.failures >= self.failures:
                st.state = "open"
                st.opened_at = now
                self._log(now, region, "opened")
                return "opened"
            return None

    def record_success(self, region: tuple, now: float) -> Optional[str]:
        """One certified success.  Closes an open/probing region (full
        reset, ``"closed"`` returned); resets the failure count of a
        closed one."""
        with self._lock:
            st = self._regions.get(region)
            if st is None:
                return None
            if st.state == "open" or st.probing:
                del self._regions[region]
                self._log(now, region, "closed")
                return "closed"
            st.failures = 0
            return None

    def abort_probe(self, region: tuple) -> None:
        """The in-flight probe left the system without a result (shed,
        deadline-expired, drained): return the region to plain OPEN so
        the next due ``admit`` probes again."""
        with self._lock:
            st = self._regions.get(region)
            if st is not None and st.probing:
                st.probing = False

    # -- introspection -----------------------------------------------------

    def state(self, region: tuple) -> str:
        """``"closed"`` / ``"open"`` / ``"half_open"`` (probe in flight)."""
        with self._lock:
            st = self._regions.get(region)
            if st is None or st.state == "closed":
                return "closed"
            return "half_open" if st.probing else "open"

    def transitions(self) -> List[tuple]:
        """The ordered ``(now, region, what)`` transition log — the load
        harness's breaker-timeline record."""
        with self._lock:
            return list(self._transitions)

    def open_regions(self) -> List[tuple]:
        with self._lock:
            return [r for r, st in self._regions.items()
                    if st.state == "open"]
