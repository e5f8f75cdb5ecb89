"""Wall timing on the host clock and iteration records (port of
``PhaseTimer``, ``stopwatch`` and the records JSONL of
``aiyagari_hark_tpu/utils/timing.py``).  A wall that covers work on the
card ends with the results on the host (a copy or a synchronize), so the
host clock sees the device's time."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from collections import defaultdict
from typing import Dict, Iterable


class PhaseTimer:
    """Accumulating named timers: ``with timer.phase("solve"): ...``.
    ``report()`` returns {phase: seconds}; ``counts`` holds invocation
    counts.  Wall-clock only: the caller synchronizes with the device
    before a phase ends, as the solvers do."""

    def __init__(self):
        self.seconds: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> Dict[str, float]:
        return dict(self.seconds)

    def summary(self) -> str:
        total = sum(self.seconds.values())
        lines = [f"{name:>12s}: {sec:8.3f}s x{self.counts[name]:<4d} "
                 f"({100.0 * sec / total:5.1f}%)"
                 for name, sec in sorted(self.seconds.items(),
                                         key=lambda kv: -kv[1])]
        return "\n".join(lines + [f"{'total':>12s}: {total:8.3f}s"])


class Stopwatch:
    """A started wall timer: ``elapsed()`` reads the running interval,
    ``seconds`` is filled at exit when used through ``stopwatch()`` (NaN
    while still running)."""

    __slots__ = ("t0", "seconds")

    def __init__(self):
        self.t0 = time.perf_counter()
        self.seconds = float("nan")

    def elapsed(self) -> float:
        """Seconds since construction (monotonic clock)."""
        return time.perf_counter() - self.t0


@contextlib.contextmanager
def stopwatch():
    """Measure one wall interval: ``with stopwatch() as sw: ...`` then read
    ``sw.seconds`` (filled even when the block raises)."""
    sw = Stopwatch()
    try:
        yield sw
    finally:
        sw.seconds = time.perf_counter() - sw.t0


def write_records_jsonl(path: str, records: Iterable,
                        append: bool = False) -> None:
    """Persist iteration records (``KSIterationRecord`` dataclasses or
    dicts) as JSON lines, through the ``utils.checkpoint`` writers:
    ``append=False`` replaces the whole file (tmp + ``os.replace``);
    ``append=True`` appends each complete line with one ``os.write``, so
    a kill tears at most the final line, which ``read_records_jsonl``
    skips."""
    from .checkpoint import append_jsonl, atomic_write_text

    lines = []
    for rec in records:
        if dataclasses.is_dataclass(rec) and not isinstance(rec, type):
            rec = dataclasses.asdict(rec)
        lines.append(json.dumps(rec) + "\n")
    if append:
        append_jsonl(path, lines)
    else:
        atomic_write_text(path, "".join(lines))


def read_records_jsonl(path: str):
    """Read a records JSONL back, skipping unparseable lines (a torn tail
    from a kill mid-append), with a warning that counts them."""
    from .checkpoint import read_jsonl_tolerant

    out, bad = read_jsonl_tolerant(path)
    if bad:
        import warnings

        warnings.warn(
            f"records jsonl {path}: skipped {bad} unparseable line(s) "
            "(torn tail from a hard kill mid-append?)", stacklevel=2)
    return out
