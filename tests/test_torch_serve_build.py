"""The kernels' first build under threads and processes, and
``CompileCounter``.

The serving tier's worker thread can use a kernel first at the same
moment as the main thread, and fleet workers started together at the
same moment as each other.  ``ops.kernels.build_libraries`` must then
build each library once and load it once in each process: a thread lock
and a file lock across processes around the check, the build and the
load.  On
the CPU there is no ``nvcc`` and no card, so the compiler and the loader
are stubs here (monkeypatched): the stub compiler writes its ``-o``
output after a pause, long enough for a racing thread to arrive.  Each
library built inside a ``CompileCounter`` window is a cache miss, each
one loaded from the build directory a hit.
"""

import json
import os
import subprocess
import sys
import threading
import time

import pytest

import aiyagari_hark_tpu_torch.ops.kernels as K
from aiyagari_hark_tpu_torch.utils.timing import CompileCounter

NAME = "egm_policy_grid"


class _StubProc:
    """A finished ``nvcc`` run: writes the ``-o`` file after a pause."""

    calls: list = []

    def __init__(self, cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        _StubProc.calls.append(out)
        time.sleep(0.2)
        with open(out, "wb") as f:
            f.write(b"ELF")
        self.returncode = 0

    def communicate(self):
        return "ptxas info: 0 bytes spill", None


@pytest.fixture
def stub_build(tmp_path, monkeypatch):
    loads = []
    _StubProc.calls = []
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(K, "_LIBS", {})
    monkeypatch.setattr(K, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(K, "_bind", lambda lib, name: None)
    monkeypatch.setattr(subprocess, "Popen", _StubProc)
    monkeypatch.setattr(K.ctypes, "CDLL",
                        lambda path: loads.append(path) or object())
    return loads


def _race(n_threads=2):
    errors = []
    barrier = threading.Barrier(n_threads)

    def first_use():
        try:
            barrier.wait()
            K._library(NAME)
        except BaseException as e:          # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors, errors


def test_two_threads_build_once_and_load_once(stub_build):
    with CompileCounter() as cc:
        _race(2)
    assert len(_StubProc.calls) == 1 and len(stub_build) == 1
    assert list(K._LIBS) == [NAME]
    so = K.BUILD_DIR / f"{NAME}-{K._digest(NAME)}.so"
    assert so.exists() and not [p for p in os.listdir(K.BUILD_DIR)
                                if p.endswith(".tmp")]
    assert (cc.compile_events, cc.cache_misses, cc.cache_hits) == (1, 1, 0)
    assert cc.compile_seconds > 0.0
    # loaded already: a later first use costs and counts nothing
    with CompileCounter() as again:
        assert K.build_libraries((NAME,)) == 0.0
    assert again.compile_events == 0


def test_cached_library_is_a_hit_and_builds_nothing(stub_build):
    K.BUILD_DIR.mkdir(parents=True)
    (K.BUILD_DIR / f"{NAME}-{K._digest(NAME)}.so").write_bytes(b"ELF")
    with CompileCounter() as outer:
        with CompileCounter() as inner:
            _race(3)
    assert _StubProc.calls == [] and len(stub_build) == 1
    for cc in (outer, inner):
        assert (cc.compile_events, cc.cache_misses, cc.cache_hits) == \
            (1, 0, 1)


def test_compile_counter_publishes_jax_names():
    from aiyagari_hark_tpu_torch.obs import MetricsRegistry

    reg = MetricsRegistry()
    with CompileCounter() as cc:
        pass
    cc.publish(reg)
    text = reg.prometheus_text()
    for name in ("aiyagari_xla_compile_events", "aiyagari_xla_cache_misses",
                 "aiyagari_xla_cache_hits", "aiyagari_xla_compile_seconds"):
        assert name in text
    assert (cc.compile_events, cc.compile_seconds, cc.cache_misses,
            cc.cache_hits) == (0, 0.0, 0, 0)


_CHILD = r"""
import json, os, pathlib, subprocess, sys, time
import aiyagari_hark_tpu_torch.ops.kernels as K

build_dir, ready, go, out = sys.argv[1:5]
calls, loads = [], []


class Stub:
    def __init__(self, cmd, **kw):
        o = cmd[cmd.index("-o") + 1]
        calls.append(o)
        time.sleep(0.5)
        with open(o, "wb") as f:
            f.write(b"ELF")
        self.returncode = 0

    def communicate(self):
        return "", None


K.BUILD_DIR = pathlib.Path(build_dir)
K._nvcc = lambda: "nvcc"
K._bind = lambda lib, name: None
subprocess.Popen = Stub
K.ctypes.CDLL = lambda path: loads.append(path) or object()
open(ready, "w").close()
while not os.path.exists(go):
    time.sleep(0.005)
K._library(sys.argv[5])
with open(out, "w") as f:
    json.dump({"calls": calls, "loads": loads}, f)
"""


def test_two_processes_build_once_and_both_load(tmp_path):
    """Two processes reach their first use together over one build
    directory (a stub compiler that takes 0.5 s): the file lock lets one
    build while the other waits, then finds the library and loads it."""
    build = tmp_path / "_build"
    names = [(str(tmp_path / f"ready{i}"), str(tmp_path / f"out{i}.json"))
             for i in range(2)]
    go = str(tmp_path / "go")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(build), ready, go, out, NAME],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True) for ready, out in names]
    try:
        deadline = time.monotonic() + 120.0
        while not all(os.path.exists(r) for r, _ in names):
            assert time.monotonic() < deadline, "children never got ready"
            assert all(p.poll() is None for p in procs), "a child died"
            time.sleep(0.01)
        open(go, "w").close()
        for p in procs:
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    got = []
    for _, out in names:
        with open(out) as f:
            got.append(json.load(f))
    assert sum(len(g["calls"]) for g in got) == 1
    assert [len(g["loads"]) for g in got] == [1, 1]
    so = build / f"{NAME}-{K._digest(NAME)}.so"
    assert so.exists() and all(g["loads"] == [str(so)] for g in got)
    assert not [p for p in os.listdir(build) if p.endswith(".tmp")]
