"""The port's serving host layers against the JAX package's, on the same
inputs: the cell index, the solution store (memory, disk, corruption,
donor search), the lease backends (shared directory, in-memory CAS, CAS
over loopback TCP, the durable CAS) and the write-ahead log's replay, the
micro-batcher's flush rule and ladders, the overload primitives and the
service's admission decisions under one injected clock, the surrogate
fit and the metrics snapshot.  These modules are host code in both
packages, so every decision must be identical; inputs come from a seeded
numpy generator.  No solve runs here (``tests/test_torch_serve.py``
holds the service's launches).
"""

import os
import threading
import warnings

import numpy as np
import pytest
import torch

import aiyagari_hark_tpu.serve as jserve
import aiyagari_hark_tpu.serve.wal as jwal
import aiyagari_hark_tpu.verify.inject as jinject
import aiyagari_hark_tpu_torch.serve as tserve
import aiyagari_hark_tpu_torch.serve.wal as twal
import aiyagari_hark_tpu_torch.verify.inject as tinject
from aiyagari_hark_tpu.obs import ObsConfig as JObsConfig
from aiyagari_hark_tpu.obs import build_obs as jbuild_obs
from aiyagari_hark_tpu.obs import read_journal as jread_journal
from aiyagari_hark_tpu.parallel.sweep import \
    neighbor_distance as jneighbor_distance
from aiyagari_hark_tpu.scenarios.aiyagari import \
    AIYAGARI_SCHEMA as JAX_SCHEMA
from aiyagari_hark_tpu_torch.obs import ObsConfig as TObsConfig
from aiyagari_hark_tpu_torch.obs import build_obs as tbuild_obs
from aiyagari_hark_tpu_torch.obs import read_journal as tread_journal
from aiyagari_hark_tpu_torch.parallel.sweep import \
    neighbor_distance as tneighbor_distance
from aiyagari_hark_tpu_torch.scenarios.aiyagari import AIYAGARI_SCHEMA

torch.set_num_threads(1)

SCALE = (4.0, 0.9, 0.4)
PKGS = {"jax": (jserve, JAX_SCHEMA), "torch": (tserve, AIYAGARI_SCHEMA)}


def _cells(rng, n):
    return np.stack([rng.uniform(1.0, 5.0, n), rng.uniform(0.0, 0.9, n),
                     rng.choice([0.2, 0.4], n)], axis=1)


def _rows(rng, n, status=None):
    """Packed Aiyagari rows: r* in (0, 4 %), positive capital, integer
    counters, a status per row (default CONVERGED)."""
    rows = np.zeros((n, len(AIYAGARI_SCHEMA.fields)))
    rows[:, 0] = rng.uniform(0.0, 0.04, n)
    rows[:, 1] = rng.uniform(4.0, 9.0, n)
    rows[:, 2] = 1.0
    rows[:, 3:6] = rng.integers(5, 500, (n, 3))
    if status is not None:
        rows[:, AIYAGARI_SCHEMA.idx("status")] = status
    return rows


# -- the cell index -------------------------------------------------------------

@pytest.mark.parametrize("seed,k", [(0, 1), (1, 4), (2, None)])
def test_cellindex_and_linear_scan_match_jax(seed, k):
    rng = np.random.default_rng(seed)
    cells = _cells(rng, 60)
    r = rng.uniform(0.0, 0.04, 60)
    r[7] = np.nan                                # NaN rows are skipped
    cert = rng.integers(-1, 3, 60)
    queries = _cells(rng, 12)
    out = {}
    for name, (mod, _) in PKGS.items():
        idx = mod.CellIndex()
        for i, c in enumerate(cells):
            idx.add(i, c, group=i % 2, r_star=float(r[i]),
                    cert_level=int(cert[i]))
        idx.remove(3, group=1)
        idx.add(3, cells[3], group=1, r_star=float(r[3]),
                cert_level=int(cert[3]))         # re-added at the tail
        out[name] = [
            idx.nearest_k(q, g, k, SCALE, require_certified=rc)
            for q in queries for g in (0, 1) for rc in (False, True)]
        out[name].append(mod.linear_nearest_k(
            queries[0], cells, np.arange(60), k, SCALE))
    assert out["torch"] == out["jax"]
    np.testing.assert_array_equal(
        tneighbor_distance(queries[1], cells, SCALE),
        jneighbor_distance(queries[1], cells, SCALE))


# -- the solution store -----------------------------------------------------------

def _fill(mod, schema, store, rng_seed=3, n=10, group=11):
    rng = np.random.default_rng(rng_seed)
    cells, rows = _cells(rng, n), _rows(rng, n)
    for i in range(n):
        store.put(mod.make_solution(cells[i], rows[i], group, 1000 + i,
                                    schema=schema))
    return cells, rows


def _store_trace(mod, schema):
    rng = np.random.default_rng(4)
    store = mod.SolutionStore(capacity=6, donor_cutoff=1.5)
    cells, rows = _fill(mod, schema, store)
    trace = [store.mem_keys(), store.known()]
    # a failed status is refused loudly; the LRU order follows every get
    bad = _rows(rng, 1, status=3)[0]
    with pytest.raises(ValueError, match="failed solution"):
        store.put(mod.make_solution(cells[0], bad, 11, 2000, schema=schema))
    trace.append(store.contains(2000))
    for key in (1004, 1009, 1001, 5555):
        sol = store.get(key)
        trace.append(None if sol is None else sol.packed.tolist())
    trace.append(store.mem_keys())
    for q in _cells(rng, 6):
        trace.append(store.nominate(q, 11, 0.1, 1e-5, scale=SCALE))
        trace.append(store.nearest(q, 11, scale=SCALE))
        trace.append([(k, tuple(m.cell), d) for k, m, d in
                      store.neighbors(q, 11, k=3, scale=SCALE)])
        trace.append(store.nominate(q, 12, 0.1, 1e-5, scale=SCALE))
    trace.append(store.integrity_counts())
    trace.append(store.index_stats())
    return trace


def test_store_get_put_neighbors_nominate_and_eviction_match_jax():
    assert _store_trace(tserve, AIYAGARI_SCHEMA) == \
        _store_trace(jserve, JAX_SCHEMA)


@pytest.mark.parametrize("mode", ["perturb", "truncate", "zero"])
def test_disk_round_trip_and_corrupt_entry_eviction_match_jax(tmp_path,
                                                              mode):
    """Entries written by one store reload bitwise in a second; the entry
    ``corrupt_store_entry`` damaged is evicted (file deleted, counted) in
    both packages, and each package reads the other's directory."""
    out = {}
    for name, (mod, schema), inject in (
            ("jax", PKGS["jax"], jinject), ("torch", PKGS["torch"],
                                             tinject)):
        d = str(tmp_path / name)
        store = mod.SolutionStore(capacity=3, disk_path=d)
        cells, rows = _fill(mod, schema, store, n=5)
        victim = 1002
        path = inject.corrupt_store_entry(d, key=victim, mode=mode)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            again = mod.SolutionStore(capacity=3, disk_path=d)
            got = [again.get(1000 + i) for i in range(5)]
        out[name] = ([None if g is None else g.packed.tolist()
                      for g in got], os.path.exists(path),
                     again.integrity_counts()["store_corrupt_evictions"])
        assert got[victim - 1000] is None and not os.path.exists(path)
        for i in (0, 1, 3, 4):
            assert np.array_equal(got[i].packed, rows[i])
    assert out["torch"] == out["jax"]
    # a directory one package wrote loads in the other, bit for bit
    for src, mod in (("jax", tserve), ("torch", jserve)):
        other = mod.SolutionStore(capacity=8, disk_path=str(tmp_path / src))
        for i in (0, 1, 3, 4):
            assert np.array_equal(other.get(1000 + i).packed,
                                  out[src][0][i])


# -- the lease backends, the CAS over loopback and the WAL ----------------------

KEY = -7_654_321_987


def _backend(mod, walmod, kind, root, clock=None):
    lease = mod.lease
    if kind == "shared-dir":
        return lease.SharedDirBackend(root), None
    if kind == "memory-cas":
        return lease.MemoryCASBackend(clock=clock), None
    if kind == "durable-cas":
        return walmod.DurableCASBackend(root, clock=clock,
                                        snapshot_every=3), None
    srv = lease.CASServer(clock=clock).start()
    return lease.LoopbackCASBackend(srv.address), srv


def _age(b, key, dt, kind, root):
    """Age one lease by ``dt`` seconds on its own substrate."""
    if kind == "shared-dir":
        path = b._path(key)
        t = os.path.getmtime(path) - dt
        os.utime(path, (t, t))
    else:
        b.backdate(key, dt)


@pytest.mark.parametrize("kind", ["shared-dir", "memory-cas",
                                  "loopback-cas", "durable-cas"])
def test_lease_backends_decide_as_jax(tmp_path, kind):
    """The election, heartbeat, reclaim and owner checks of each backend,
    the same decisions in both packages."""
    out = {}
    for name, mod, walmod in (("jax", jserve, jwal),
                              ("torch", tserve, twal)):
        root = str(tmp_path / name)
        os.makedirs(root, exist_ok=True)
        b, srv = _backend(mod, walmod, kind, root)
        try:
            t = [b.try_acquire(KEY, "a"), b.try_acquire(KEY, "b"),
                 b.owner_of(KEY), b.heartbeat(KEY, "a"),
                 b.heartbeat(KEY, "b"), b.release(KEY, "b"),
                 b.break_stale(KEY, ttl_s=30.0)]
            _age(b, KEY, 100.0, kind, root)
            t += [b.break_stale(KEY, ttl_s=30.0), b.owner_of(KEY),
                  b.try_acquire(KEY, "b"), b.release(KEY, "a"),
                  b.owner_of(KEY), b.age_s(KEY) is not None,
                  b.age_s(KEY, now=0.0) == 0.0,     # backward clock: fresh
                  b.release(KEY, "b"), b.age_s(KEY), b.owner_of(KEY)]
            won = []

            def claim(i):
                if b.try_acquire(17, f"w{i}"):
                    won.append(i)

            threads = [threading.Thread(target=claim, args=(i,))
                       for i in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            t += [len(won), sorted(b.list_keys())]
            out[name] = t
        finally:
            b.close()
            if srv is not None:
                srv.stop()
    assert out["torch"] == out["jax"]
    assert out["torch"][:3] == [True, False, "a"]


def test_make_backend_spellings_and_replicated_not_ported(tmp_path):
    """Every spelling builds the same backend in both packages; the
    replicated one (once not ported) is each package's quorum client,
    and an even replica count is refused in both."""
    import aiyagari_hark_tpu.serve.replicated as jrep
    import aiyagari_hark_tpu_torch.serve.replicated as trep

    for mod, rep in ((jserve, jrep), (tserve, trep)):
        assert isinstance(mod.make_backend("dir", root=str(tmp_path)),
                          mod.SharedDirBackend)
        assert isinstance(mod.make_backend("memory"), mod.MemoryCASBackend)
        with pytest.raises(ValueError, match="requires a store root"):
            mod.make_backend("dir")
        with pytest.raises(ValueError, match="unknown lease backend"):
            mod.make_backend("zookeeper")
        quorum = mod.make_backend(
            "replicated:127.0.0.1:1, 127.0.0.1:2,127.0.0.1:3")
        assert isinstance(quorum, rep.ReplicatedCASBackend)
        assert (quorum.addresses, quorum.majority) == (
            ["127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"], 2)
        quorum.close()
        with pytest.raises(ValueError, match="odd replica count"):
            mod.make_backend("replicated:127.0.0.1:1,127.0.0.1:2")


def _wal_state(backend):
    return {int(k): (o, float(t), int(v)) for k, o, t, v in backend.dump()}


def test_wal_replays_after_torn_append_as_jax(tmp_path):
    """A durable CAS killed mid-append: the torn final line is skipped
    with a warning and one WAL_REPLAY event, every acknowledged record
    replays, and a compaction in between changes nothing."""
    out = {}
    for name, walmod, build, cfg, read in (
            ("jax", jwal, jbuild_obs, JObsConfig, jread_journal),
            ("torch", twal, tbuild_obs, TObsConfig, tread_journal)):
        d = str(tmp_path / name)
        clock = iter(float(i) for i in range(100)).__next__
        b = walmod.DurableCASBackend(d, clock=clock, snapshot_every=3)
        for key in range(5):
            assert b.try_acquire(key, f"o{key}")
        b.release(2, "o2")
        before = _wal_state(b)
        with open(os.path.join(d, walmod.WAL_NAME), "ab") as f:  # atomic-ok: test writes the torn tail
            f.write(b'{"seq": 99, "k": 9, "o": "to')
        jp = str(tmp_path / f"{name}.jsonl")
        obs = build(cfg(enabled=True, journal_path=jp))
        with pytest.warns(UserWarning, match="torn final"):
            reborn = walmod.DurableCASBackend(d, snapshot_every=3, obs=obs)
        obs.close()
        assert _wal_state(reborn) == before
        (ev,) = read(jp, event="WAL_REPLAY")
        out[name] = (before, ev["torn_skipped"], ev["applied"],
                     sorted(os.listdir(d)))
    assert out["torch"] == out["jax"]


# -- the micro-batcher ------------------------------------------------------------

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _batcher_trace(mod):
    clock = FakeClock()
    b = mod.MicroBatcher(max_batch=4, max_wait_s=0.5, max_queue=6,
                         ladder=(1, 2, 4), clock=clock,
                         priority_of=lambda p: p[1])
    trace = [b.ladder, [b.pad_to(n) for n in (1, 2, 3, 4)]]
    for i in range(3):
        b.offer("g", (i, i % 3))
        clock.t += 0.1
    b.offer("h", (10, 0))
    trace += [b.depth(), b.pop_ready(), b.next_deadline()]
    clock.t = 0.5
    trace.append(b.pop_ready())
    for i in range(5):                           # depth 1 + 5 = max_queue
        b.offer("g", (20 + i, i % 3))
    try:
        b.offer("g", (99, 0), block=False)
    except mod.ServeQueueFull as e:
        trace.append(("full", e.depth, e.max_queue, e.oldest_wait_s))
    trace.append(b.shed_lowest(max_class=0))
    trace.append(b.shed_lowest(max_class=2))
    trace.append(b.pop_ready())
    trace.append(b.pop_all())
    trace.append([mod.default_ladder(n) for n in (1, 3, 8, 12)])
    trace.append([mod.shard_ladder((1, 2, 4, 8), m) for m in (1, 3, 4)])
    return trace


def test_batcher_flush_rule_and_ladders_match_jax():
    assert _batcher_trace(tserve) == _batcher_trace(jserve)
    with pytest.raises(ValueError):
        tserve.shard_ladder((1, 2), 0)


# -- overload: the breaker and the service's admission decisions ------------------

def _breaker_trace(mod):
    cb = mod.CircuitBreaker.from_policy(mod.AdmissionPolicy(
        breaker_failures=2, breaker_cooldown_s=1.0, breaker_backoff_cap=4))
    region = cb.region_key((3.0, 0.6, 0.2), 42)
    trace = [region, mod.predicted_work((1.0, 0.0, 0.2)),
             mod.predicted_work((5.0, 0.9, 0.4), scenario="huggett"),
             [mod.priority_name(p) for p in range(4)]]
    for now, op in ((0.0, "f"), (0.1, "f"), (0.2, "a"), (1.1, "a"),
                    (1.2, "a"), (1.3, "f"), (2.0, "a"), (3.4, "a"),
                    (3.5, "s"), (3.6, "a")):
        if op == "f":
            trace.append(cb.record_failure(region, now))
        elif op == "s":
            trace.append(cb.record_success(region, now))
        else:
            trace.append((cb.admit(region, now),
                          cb.retry_after(region, now)))
        trace.append(cb.state(region))
    trace += [cb.transitions(), cb.open_regions()]
    return trace


def test_circuit_breaker_and_predicted_work_match_jax():
    assert _breaker_trace(tserve) == _breaker_trace(jserve)


def _admission_trace(mod, seed, **svc_kw):
    """Submit-time admission decisions (no flush, so nothing solves):
    occupancy by predicted work, nested class budgets, shedding, the
    deadline gates and the queue bound, under one injected clock."""
    clock = FakeClock()
    pol = mod.AdmissionPolicy(max_work=6.0, est_batch_s=0.5)
    svc = mod.EquilibriumService(start_worker=False, max_batch=4,
                                 max_queue=8, ladder=(1, 2, 4),
                                 max_wait_s=60.0, clock=clock,
                                 admission=pol, **svc_kw)
    kw = dict(a_count=10, dist_count=32, labor_states=3, r_tol=1e-5,
              dtype=np.float64)
    rng = np.random.default_rng(seed)
    trace, futs = [], []
    for i in range(14):
        cell = (float(rng.choice([1.0, 3.0, 5.0])),
                float(rng.choice([0.0, 0.3, 0.6, 0.9])))
        prio = int(rng.integers(0, 3))
        deadline = [None, 0.0, 0.2, 5.0][int(rng.integers(0, 4))]
        clock.t += 0.05
        try:
            futs.append(svc.submit(mod.make_query(*cell, priority=prio,
                                                  **kw),
                                   deadline=deadline))
            trace.append(("queued", cell, prio))
        except Exception as e:
            trace.append((type(e).__name__, getattr(e, "status", None),
                          getattr(e, "reason", None),
                          round(getattr(e, "est_wait_s", 0.0), 9)))
    trace.append([type(f.exception(0)).__name__ if f.done() else "pending"
                  for f in futs])
    trace.append(svc.batcher.depth())
    snap = svc.metrics.snapshot()
    trace.append({k: snap[k] for k in (
        "serve_overloaded", "serve_load_sheds", "serve_deadline_rejects_"
        "submit", "serve_queue_depth_peak")})
    svc.close(drain=False)
    return trace


@pytest.mark.parametrize("seed", [7, 15, 26])   # overloads; sheds (15, 26)
def test_admission_decisions_match_jax(seed):
    t = _admission_trace(tserve, seed, device="cpu")
    assert t == _admission_trace(jserve, seed)
    assert t[-1]["serve_overloaded"] > 0


# -- the surrogate fit and the metrics snapshot -----------------------------------

@pytest.mark.parametrize("seed,n", [(0, 1), (1, 3), (2, 6), (3, 10)])
def test_fit_surrogate_matches_jax(seed, n):
    rng = np.random.default_rng(seed)
    cell = _cells(rng, 1)[0]
    donors = _cells(rng, n)
    r = rng.uniform(0.0, 0.04, n)
    d = tneighbor_distance(cell, donors, SCALE)
    a = tserve.fit_surrogate(cell, donors, r, d, SCALE, floor=1e-6)
    b = jserve.fit_surrogate(cell, donors, r, d, SCALE, floor=1e-6)
    assert a.linear == b.linear
    for x, y in ((a.r_star, b.r_star), (a.bound, b.bound)):
        assert abs(x - y) <= 1e-12
    np.testing.assert_allclose(a.kernel, b.kernel, rtol=0, atol=1e-12)
    assert tserve.fit_surrogate(cell, np.zeros((0, 3)), [], [],
                                SCALE) is None


def _metrics_snapshot(mod):
    m = mod.ServeMetrics()
    for path, lat in (("hit", 1e-4), ("cold", 2.0), ("near", 1.0),
                      ("degraded", 1e-3), ("surrogate", 2e-4)):
        m.record_served(path, lat, scenario="aiyagari")
    m.record_batch(3, 4)
    m.record_failure(0.5)
    m.record_certificate(0)
    m.record_phases(0, 100, 0)
    m.note_queue_depth(3)
    return m.snapshot()


def test_metrics_snapshot_keys_and_values_match_jax():
    t, j = _metrics_snapshot(tserve), _metrics_snapshot(jserve)
    assert list(t) == list(j)
    assert t == j
    for mod in (tserve, jserve):
        assert mod.ServeMetrics().compile.compile_events == 0
