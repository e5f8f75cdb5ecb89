"""Micro-batching for equilibrium queries: bounded queue, shape ladder
(port of ``aiyagari_hark_tpu/serve/batcher.py``, host code, copied).

The device economics (DESIGN §8): one batched launch amortizes dispatch
overhead across lanes.  The JAX service compiles one executable per input
shape, so it pads every flush up to a small **ladder** of fixed shapes
(default: powers of two up to ``max_batch``).  The port keeps the ladder:
its kernels compile once per layout, not per shape, but the ladder keeps
the launch shapes, the cost ledger's entries and the paddings the JAX
service's.  Padded lanes duplicate a real lane's inputs (identical bits,
masked out at scatter) — the sweep's padding rule.

Flush policy: a group flushes when it holds ``max_batch`` requests
(occupancy-bound) or when its oldest request has waited ``max_wait_s``
(latency-bound).  The clock is injectable, so the deadline machinery is
property-testable with a deterministic fake clock; the bounded queue
(``max_queue`` across groups) sheds load by blocking or raising
``ServeQueueFull``.

This module is deliberately generic: items are opaque (the service's
pending-request records), groups are opaque hashable keys (the service
uses (scenario, dtype, kwargs) — only same-configuration queries can
share a launch).  Host code: no torch, no device."""

from __future__ import annotations

import threading
import time
from typing import Hashable, List, Optional, Tuple


class ServeQueueFull(RuntimeError):
    """The bounded request queue is at capacity and the caller asked not
    to block (or timed out blocking).

    Carries the queue state at rejection time so callers can implement
    retry-after: ``depth`` (queued requests),
    ``max_queue`` (the bound), and ``oldest_wait_s`` (how long the
    oldest queued request has waited, in injected-clock units — a proxy
    for drain speed; None on an empty queue)."""

    def __init__(self, message: str, depth: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 oldest_wait_s: Optional[float] = None):
        super().__init__(message)
        self.depth = depth
        self.max_queue = max_queue
        self.oldest_wait_s = oldest_wait_s


def default_ladder(max_batch: int) -> Tuple[int, ...]:
    """Powers of two up to and including ``max_batch``: the shape set a
    warmed service compiles, e.g. ``max_batch=8 -> (1, 2, 4, 8)``,
    ``max_batch=12 -> (1, 2, 4, 8, 12)``."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    ladder = []
    s = 1
    while s < max_batch:
        ladder.append(s)
        s *= 2
    ladder.append(max_batch)
    return tuple(ladder)


def shard_ladder(ladder: Tuple[int, ...], multiple: int) -> Tuple[int, ...]:
    """Round every ladder shape up to a multiple of ``multiple`` (the
    lane-axis device count) and dedupe, preserving order by size — the
    multi-chip ladder: every flush shape divides evenly
    across the mesh, so a sharded launch never needs a second padding
    pass and a warmed multi-chip service still owns ONE executable per
    (rounded) ladder shape per solver group.  ``multiple=1`` is the
    identity."""
    if multiple < 1:
        raise ValueError(f"shard multiple must be >= 1, got {multiple}")
    if multiple == 1:
        return tuple(ladder)
    return tuple(sorted({-(-int(s) // multiple) * multiple
                         for s in ladder}))


class MicroBatcher:
    """Collects requests per group behind a bounded queue and releases
    them as ladder-shaped batches on size or deadline."""

    def __init__(self, max_batch: int = 8, max_wait_s: float = 0.002,
                 max_queue: int = 1024,
                 ladder: Optional[Tuple[int, ...]] = None,
                 clock=time.monotonic, priority_of=None,
                 shard_multiple: int = 1):
        # shard_multiple: the lane-axis device count — every
        # ladder shape rounds UP to a multiple so flushes dispatch
        # evenly across a mesh (1 = unsharded, the identity)
        self.shard_multiple = int(shard_multiple)
        self.ladder = shard_ladder(
            default_ladder(max_batch) if ladder is None
            else tuple(sorted(set(int(s) for s in ladder))),
            self.shard_multiple)
        if not self.ladder or self.ladder[0] < 1:
            raise ValueError(f"invalid ladder {self.ladder}")
        self.max_batch = self.ladder[-1]
        if max_batch > self.max_batch:
            raise ValueError(
                f"max_batch={max_batch} exceeds the ladder's largest "
                f"shape {self.max_batch}; every flush must pad to a "
                "ladder shape")
        self.max_wait_s = float(max_wait_s)
        self.max_queue = int(max_queue)
        self.clock = clock
        # item -> priority class (int; LOWER = more important) for
        # ``shed_lowest``; None disables shedding (items stay opaque)
        self._priority_of = priority_of
        self._cond = threading.Condition()
        self._groups: dict = {}     # group -> list of (item, t_enqueued)
        self._depth = 0

    def pad_to(self, n: int) -> int:
        """Smallest ladder shape >= n (the launch shape for n real lanes)."""
        for s in self.ladder:
            if s >= n:
                return s
        return self.max_batch

    def depth(self) -> int:
        with self._cond:
            return self._depth

    def _oldest_wait(self, now: float) -> Optional[float]:
        """Wait of the oldest queued request in clock units (lock held)."""
        oldest = [entries[0][1] for entries in self._groups.values()
                  if entries]
        if not oldest:
            return None
        return now - min(oldest)

    def _full_error(self, message: str) -> ServeQueueFull:
        """A payload-carrying ``ServeQueueFull`` (lock held)."""
        now = self.clock()
        return ServeQueueFull(message, depth=self._depth,
                              max_queue=self.max_queue,
                              oldest_wait_s=self._oldest_wait(now))

    def offer(self, group: Hashable, item, block: bool = True,
              timeout: Optional[float] = None) -> None:
        """Enqueue one request.  At capacity: block (optionally up to
        ``timeout``) or raise ``ServeQueueFull`` (carrying depth /
        max_queue / oldest-wait so callers can retry-after).

        The block timeout is measured on the INJECTED clock so backpressure is property-testable with a fake
        clock — advance the clock past the timeout and ``kick()`` to
        wake the blocked caller deterministically.  An equal real-time
        backstop still bounds the wait when the injected clock is the
        real one (they coincide) or has stalled (a fake clock nobody
        advances must not block a caller forever)."""
        t0 = self.clock()
        real_deadline = (None if timeout is None
                         else time.monotonic() + timeout)  # timing-ok: real-time backstop, not a measured wall
        with self._cond:
            while self._depth >= self.max_queue:
                if not block:
                    raise self._full_error(
                        f"serving queue at capacity ({self.max_queue})")
                if timeout is not None:
                    clock_left = timeout - (self.clock() - t0)
                    real_left = real_deadline - time.monotonic()  # timing-ok: backstop deadline check
                    if clock_left <= 0 or real_left <= 0:
                        raise self._full_error(
                            f"serving queue still at capacity "
                            f"({self.max_queue}) after {timeout:g}s")
                    self._cond.wait(min(clock_left, real_left))
                else:
                    self._cond.wait(None)
            self._groups.setdefault(group, []).append((item, self.clock()))
            self._depth += 1
            self._cond.notify_all()

    def kick(self) -> None:
        """Wake every blocked ``offer``/``wait_ready`` so it re-reads the
        injected clock — pair with fake-clock advances in tests and the
        load harness."""
        with self._cond:
            self._cond.notify_all()

    def shed_lowest(self, max_class: Optional[int] = None):
        """Remove and return the single most-sheddable queued request as
        ``(group, item)``: the one in the numerically-HIGHEST (least
        important) priority class, youngest within the class — shedding
        the youngest wastes the least accumulated waiting.  Only items whose class is STRICTLY greater than
        ``max_class`` (the displacing arrival's class) are eligible.
        None when nothing is sheddable or no ``priority_of`` was given."""
        if self._priority_of is None:
            return None
        with self._cond:
            best = None          # ((class, t_enqueued), group, index)
            for group, entries in self._groups.items():
                for idx, (item, t) in enumerate(entries):
                    c = int(self._priority_of(item))
                    if max_class is not None and c <= int(max_class):
                        continue
                    key = (c, t)
                    if best is None or key > best[0]:
                        best = (key, group, idx)
            if best is None:
                return None
            _, group, idx = best
            item, _t = self._groups[group].pop(idx)
            if not self._groups[group]:
                del self._groups[group]
            self._depth -= 1
            self._cond.notify_all()
            return group, item

    def ready(self, now: Optional[float] = None) -> bool:
        """True iff ``pop_ready(now)`` would release at least one batch
        (a full group, or an oldest request past ``max_wait_s``) —
        non-destructive, for harnesses scheduling around the batcher."""
        if now is None:
            now = self.clock()
        with self._cond:
            for entries in self._groups.values():
                if len(entries) >= self.max_batch:
                    return True
                # same boundary arithmetic as pop_ready/next_deadline
                if entries and now >= entries[0][1] + self.max_wait_s:
                    return True
        return False

    def _pop_from(self, group: Hashable, n: int) -> list:
        entries = self._groups[group]
        taken = [item for item, _ in entries[:n]]
        rest = entries[n:]
        if rest:
            self._groups[group] = rest
        else:
            del self._groups[group]
        self._depth -= len(taken)
        self._cond.notify_all()
        return taken

    def pop_ready(self, now: Optional[float] = None) -> List[tuple]:
        """Batches due at ``now`` (default: the injected clock), as
        ``(group, [items...])`` — full groups first (oldest requests),
        then deadline-expired groups.  Non-blocking."""
        if now is None:
            now = self.clock()
        out = []
        with self._cond:
            for group in list(self._groups):
                while len(self._groups.get(group, ())) >= self.max_batch:
                    out.append((group, self._pop_from(group,
                                                      self.max_batch)))
                entries = self._groups.get(group)
                # due test in the SAME arithmetic next_deadline()
                # reports (oldest + max_wait_s): ``now - oldest >=
                # max_wait_s`` can round the other way at the boundary,
                # leaving a caller who advanced exactly to the reported
                # deadline spinning on a never-due batch
                if entries and now >= entries[0][1] + self.max_wait_s:
                    out.append((group, self._pop_from(group,
                                                      self.max_batch)))
        return out

    def pop_all(self) -> List[tuple]:
        """Everything still queued, chunked at ``max_batch`` — the drain
        path (service shutdown)."""
        out = []
        with self._cond:
            for group in list(self._groups):
                while group in self._groups:
                    out.append((group, self._pop_from(group,
                                                      self.max_batch)))
        return out

    def next_deadline(self) -> Optional[float]:
        """Earliest instant (in clock units) a queued group becomes due,
        or None when the queue is empty."""
        with self._cond:
            oldest = [entries[0][1] for entries in self._groups.values()
                      if entries]
        if not oldest:
            return None
        return min(oldest) + self.max_wait_s

    def wait_ready(self, timeout: Optional[float] = None) -> List[tuple]:
        """Block (on real time) until at least one batch is due, then
        return the due batches; ``[]`` on timeout.  The worker thread's
        wait primitive — uses the injected clock only for deadlines, real
        time for the condition wait."""
        end = (None if timeout is None
               else time.monotonic() + timeout)  # timing-ok: worker real-time wait bound
        with self._cond:
            while True:
                ready = self.pop_ready()
                if ready:
                    return ready
                nd = self.next_deadline()
                wait = None
                if nd is not None:
                    wait = max(0.0, nd - self.clock())
                if end is not None:
                    remaining = end - time.monotonic()  # timing-ok: wait bound, not a wall
                    if remaining <= 0:
                        return []
                    wait = remaining if wait is None else min(wait,
                                                              remaining)
                self._cond.wait(wait)
