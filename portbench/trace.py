"""The reduction of a ``torch.profiler`` trace of the measured window to
the numbers the per-layer readers take: the device's busy time, the
time of the program's own kernels, the device operations that took most
time, and the idle gaps by what the host was doing.

The window is the benchmark's own ``record_function`` range
(``WINDOW``); device activity (kernels, copies, sets) is clipped to it.
The program's kernels are those whose names its CUDA sources declare
``__global__`` (``port_kernel_names``), so a kernel a later change adds
there is counted without an edit here.  An idle gap is named by the
innermost host operation, on the window's thread, that covers its
midpoint.
"""

from __future__ import annotations

import re
from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass
from pathlib import Path

WINDOW = "portbench/window"
SWEEP = "portbench/sweep"
TOP = 10
NAME_CHARS = 160


def port_kernel_names(csrc: Path) -> set:
    """The names of the ``__global__`` functions in the CUDA sources under
    ``csrc`` (``*.cu``, ``*.cuh``)."""
    names = set()
    for f in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        text = f.read_text()
        for m in re.finditer(r"__global__\b", text):
            rest = text[m.end():]
            # skip the return type and any __launch_bounds__(...), whose
            # arguments may nest parentheses; the name precedes the first
            # parenthesis left after that
            rest = re.sub(r"^\s*void\s+", "", rest)
            while rest.startswith("__launch_bounds__"):
                depth, i = 0, len("__launch_bounds__")
                while i < len(rest):
                    depth += {"(": 1, ")": -1}.get(rest[i], 0)
                    i += 1
                    if depth == 0 and rest[i - 1] == ")":
                        break
                rest = rest[i:].lstrip()
            found = re.match(r"(\w+)\s*\(", rest)
            if found:
                names.add(found.group(1))
    return names


class Tracer:
    """The PyTorch profiler (host operations, and the card's activity on
    a card) driven below ``torch.profiler.profile``: ``stop`` returns the
    raw kineto events without building the profiler's Python event tree,
    which the reduction does not read and which costs minutes for a
    window of some millions of events."""

    def __init__(self, cuda: bool):
        from torch.autograd import profiler

        self.cuda = cuda
        self._prof = profiler.profile(use_device="cuda" if cuda else None,
                                      use_kineto=True)

    def start(self) -> None:
        self._prof._prepare_trace()
        self._prof._start_trace()

    def stop(self):
        import torch
        from torch._C._autograd import _disable_profiler

        if self.cuda:
            torch.cuda.synchronize()
        return _disable_profiler().events()


def _short(name: str) -> str:
    """A kernel's name without ``void``, the anonymous namespace and its
    argument list."""
    name = name.replace("(anonymous namespace)::", "").strip()
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                return name[:i].strip()
    return name


def _annotation(e) -> bool:
    """Whether a device event is a ``record_function`` range mirrored on
    the card's timeline (no work of the card)."""
    if hasattr(e, "is_user_annotation"):
        return bool(e.is_user_annotation())
    return e.name() in (WINDOW, SWEEP)


def _merge(intervals):
    """Union of [start, end) intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float             # union of all device activity in the window
    port_s: float             # summed time of the program's kernels
    port_union_s: float       # union of the program's kernels' intervals
    port_launches: int
    device_ops: list          # [[name, seconds]], most time first
    idle_gaps: list           # [[host operation, seconds]], most first


def summarize(events, port_names: set):
    """``TraceSummary`` of kineto ``events`` (``Tracer.stop``), or None
    when the trace holds no window or no device activity.  Some millions
    of events: each event's fields are read once, and a name only where
    it is used."""
    from torch._C._autograd import DeviceType

    host_type = DeviceType.CPU
    cpu, dev = [], []
    window = None
    for e in events:
        if e.device_type() == host_type:
            s = e.start_ns()
            cpu.append((s, s + e.duration_ns(), e.start_thread_id(), e))
            if e.is_user_annotation() and e.name() == WINDOW:
                window = cpu[-1]
        elif not _annotation(e):
            s = e.start_ns()
            dev.append((s, s + e.duration_ns(), e.name()))
    if window is None:
        return None
    w0, w1, tid, _ = window
    dev = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    if not dev:
        return None
    busy = _merge([(s, e) for s, e, _ in dev])
    pattern = re.compile(r"\b(" + "|".join(sorted(port_names)) + r")\b") \
        if port_names else None
    port = [(s, e) for s, e, n in dev if pattern and pattern.search(n)]
    by_name = defaultdict(float)
    for s, e, n in dev:
        by_name[_short(n)[:NAME_CHARS]] += (e - s) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    # host operations on the window's thread, nested: each one's parent is
    # the innermost earlier one still open at its start
    host = sorted((r for r in cpu if r[2] == tid and w0 <= r[0] < w1),
                  key=lambda r: (r[0], -r[1]))
    del cpu
    parent, stack = [], []
    for i, r in enumerate(host):
        while stack and host[stack[-1]][1] < r[1]:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    starts = [r[0] for r in host]
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        j = bisect_right(starts, mid) - 1
        while j >= 0 and host[j][1] < mid:
            j = parent[j]
        gaps[j] += (g1 - g0) * 1e-9
    named = defaultdict(float)
    for j, sec in gaps.items():
        named[host[j][3].name() if j >= 0
              else "host outside any operation"] += sec
    idle = sorted(named.items(), key=lambda kv: -kv[1])[:TOP]
    return TraceSummary(
        window_s=(w1 - w0) * 1e-9,
        busy_s=sum(e - s for s, e in busy) * 1e-9,
        port_s=sum(e - s for s, e in port) * 1e-9,
        port_union_s=sum(e - s for s, e in _merge(port)) * 1e-9,
        port_launches=len(port),
        device_ops=[[n, s] for n, s in ops],
        idle_gaps=[[n, s] for n, s in idle])
