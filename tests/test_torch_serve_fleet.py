"""The serving tier's shared store, the service's fleet path, the
surrogate answer and the neighbour prefetch: the port against the JAX
package on the CPU, in float64 at the serve width of
``tests/test_torch_serve.py``.

Each test drives one sequence through both packages, each on its own
directory under one ``tmp_path``, and holds the port's decisions equal to
JAX's: claim verdicts, lease files, fleet counters, the ``FLEET_*``,
``SURROGATE_*``, ``PREFETCH_ISSUED`` and ``LATTICE_REFINED`` journal
events, metric snapshots and every answer's path and status.  Solved
values are held as ``tests/test_torch_serve.py`` holds them: r* within
``100 * r_tol`` pct, capital to ``rtol=1e-6``.  Within the port a peer's
publish is served bitwise.  A surrogate answer, a fit over the same stored
rows, agrees with JAX's to 1e-12.

Covered: claim won/lost/published, publish, release, the stale-lease
reclaim (claim path and end-of-run sweep), the heartbeat keeping a live
claim; the service's in-batch dedup, a peer's publish served as a remote
hit, a claim loser serving the winner's publish or taking over an
abandoned claim, a failed lane releasing its claim; the surrogate served,
escalated for each reason and audited; prefetch issued, suppressed under
admission and tagged speculative on publish.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

import aiyagari_hark_tpu.serve as jserve
import aiyagari_hark_tpu.utils.checkpoint as jck
import aiyagari_hark_tpu_torch.serve as tserve
import aiyagari_hark_tpu_torch.utils.checkpoint as tck
from aiyagari_hark_tpu.obs import ObsConfig as JObsConfig
from aiyagari_hark_tpu.obs import read_journal as jread_journal
from aiyagari_hark_tpu.obs.runtime import build_obs as jbuild_obs
from aiyagari_hark_tpu.scenarios.aiyagari import AIYAGARI_SCHEMA as JSCHEMA
from aiyagari_hark_tpu_torch.obs import ObsConfig as TObsConfig
from aiyagari_hark_tpu_torch.obs import read_journal as tread_journal
from aiyagari_hark_tpu_torch.obs.runtime import build_obs as tbuild_obs
from aiyagari_hark_tpu_torch.scenarios.aiyagari import (
    AIYAGARI_SCHEMA as TSCHEMA,
)
from aiyagari_hark_tpu_torch.solver_health import CONVERGED

torch.set_num_threads(1)
KW = dict(a_count=10, dist_count=32, labor_states=3, r_tol=1e-5,
          max_bisect=24)
LATTICE = [(s, r, 0.2) for s in (1.0, 3.0, 5.0)
           for r in (0.0, 0.3, 0.6, 0.9)]
PKGS = ("jax", "torch")
M = {"jax": dict(serve=jserve, ck=jck, obs_cfg=JObsConfig,
                 read=jread_journal, build_obs=jbuild_obs, schema=JSCHEMA,
                 dtype=np.float64, extra={}),
     "torch": dict(serve=tserve, ck=tck, obs_cfg=TObsConfig,
                   read=tread_journal, build_obs=tbuild_obs,
                   schema=TSCHEMA, dtype=torch.float64,
                   extra={"device": "cpu"})}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _row(pkg, root=0.01):
    """A healthy synthetic packed row in the Aiyagari layout."""
    schema = M[pkg]["schema"]
    row = np.zeros(len(schema.fields))
    row[schema.idx(schema.root)] = root
    return row


def _store(pkg, tmp_path, owner, **over):
    kw = dict(disk_path=str(tmp_path / pkg / "shared"), shared=True,
              lease_ttl_s=5.0)
    kw.update(over)
    return M[pkg]["serve"].SolutionStore(owner=owner, **kw)


def _svc(pkg, store=None, **over):
    kw = dict(start_worker=False, max_batch=4, max_wait_s=60.0,
              ladder=(1, 2, 4), clock=FakeClock())
    kw.update(M[pkg]["extra"])
    kw.update(over)
    return M[pkg]["serve"].EquilibriumService(store=store, **kw)


def _q(pkg, s, r, sd=0.2, **kw):
    return M[pkg]["serve"].make_query(s, r, labor_sd=sd,
                                      dtype=M[pkg]["dtype"], **KW, **kw)


def _obs(pkg, tmp_path, name="j"):
    path = str(tmp_path / f"{pkg}-{name}.jsonl")
    return M[pkg]["obs_cfg"](enabled=True, journal_path=path), path


def _events(pkg, path, event, keep=()):
    return [{k: e.get(k) for k in keep}
            for e in M[pkg]["read"](path, event=event)]


def _solve(svc, q):
    fut = svc.submit(q)
    if not fut.done():
        svc.flush()
    return fut.result(0)


def assert_matches_jax(t, j, r_tol=KW["r_tol"]):
    assert (t.path, t.status, t.bisect_iters, t.quality) == \
        (j.path, j.status, j.bisect_iters, j.quality)
    assert abs(t.r_star - j.r_star) * 100.0 <= 100.0 * r_tol
    if np.isfinite(j.capital):
        np.testing.assert_allclose(t.capital, j.capital, rtol=1e-6)


def _both(fn, *args):
    """``fn(pkg, *args)`` for each package: (port's, JAX's)."""
    out = {pkg: fn(pkg, *args) for pkg in PKGS}
    return out["torch"], out["jax"]


# -- the shared store: election, publish, release, reclaim ---------------------

def _election(pkg, tmp_path):
    ck = M[pkg]["ck"]
    obs = M[pkg]["build_obs"](_obs(pkg, tmp_path)[0])
    a = _store(pkg, tmp_path, "A", obs=obs)
    b = _store(pkg, tmp_path, "B", lease_ttl_s=1.0)
    sol = M[pkg]["serve"].make_solution((3.0, 0.6, 0.2), _row(pkg, 0.0123),
                                        group=7, key=42)
    log = [a.claim(42), b.claim(42), a.held_leases(),
           [os.path.basename(p) for p in a.lease_files()]]
    a.publish(sol, speculative=True, seed=(0.0, 0.05, 3))
    log += [a.held_leases(), a.lease_files(), b.claim(42)]
    got = b.get(42)
    assert got is not None
    assert np.array_equal(np.asarray(got.packed), _row(pkg, 0.0123))
    # a release without a publish reopens the election at once
    log += [a.claim(7), b.claim(7)]
    a.release(7)
    log += [b.claim(7), a.claim(7)]
    b.release(7)
    # a crashed owner's lease, backdated past the TTL: the end-of-run
    # sweep breaks it, and so does a claim
    old = time.time() - 10.0
    dead = os.path.join(str(tmp_path / pkg / "shared"),
                        "lease_feedbeef.lease")
    ck.acquire_lease(dead, owner="dead")
    os.utime(dead, (old, old))
    log.append(b.gc_stale_leases())
    lease = b._lease_file(9)
    ck.acquire_lease(lease, owner="dead")
    os.utime(lease, (old, old))
    log += [b.claim(9), b.lease_stale(9), b.reclaim_if_stale(9)]
    b.release(9)
    log += [a.fleet_counts(), b.fleet_counts(), b.lease_files()]
    a.close()
    b.close()
    obs.close()
    jp = _obs(pkg, tmp_path)[1]
    log.append([(e["event"], e.get("key"), e.get("owner"),
                 e.get("speculative"), e.get("seed"))
                for e in M[pkg]["read"](jp)
                if e["event"].startswith("FLEET_")])
    return log


def test_shared_store_election_and_reclaim_decide_as_jax(tmp_path):
    t, j = _both(_election, tmp_path)
    assert t == j
    assert t[:3] == ["won", "lost", [42]]
    assert t[-1] == [("FLEET_CLAIM", 42, "A", None, None),
                     ("FLEET_PUBLISH", 42, "A", True, [0.0, 0.05, 3]),
                     ("FLEET_CLAIM", 7, "A", None, None)]


def _heartbeat(pkg, tmp_path):
    a = _store(pkg, tmp_path, "A", lease_ttl_s=0.4)
    b = _store(pkg, tmp_path, "B", lease_ttl_s=0.4)
    log = [a.claim(5)]
    time.sleep(1.0)                  # 2.5 TTLs: only the heartbeat saves it
    health = a.heartbeat_health()
    log += [b.lease_stale(5), b.claim(5),
            b.fleet_counts()["fleet_lease_reclaims"],
            health["thread_alive"], health["held"], health["beats"] > 0]
    a.release(5)
    a.close()
    b.close()
    log.append(a.heartbeat_health()["thread_alive"])
    return log


def test_heartbeat_keeps_a_live_claim_as_jax(tmp_path):
    t, j = _both(_heartbeat, tmp_path)
    assert t == j == ["won", False, "lost", 0, True, 1, True, False]


# -- the service's fleet gate --------------------------------------------------

def _dedup_and_remote_hit(pkg, tmp_path):
    a = _svc(pkg, _store(pkg, tmp_path, "A"))
    futs = [a.submit(_q(pkg, *c)) for c in ((5.0, 0.0), (5.0, 0.0),
                                            (1.0, 0.3))]
    a.flush()
    ra = [f.result(0) for f in futs]
    b = _svc(pkg, _store(pkg, tmp_path, "B"))
    fb = b.submit(_q(pkg, 5.0, 0.0))
    at_submit = fb.done()
    rb = _solve(b, _q(pkg, 5.0, 0.0)) if not at_submit else fb.result(0)
    log = [at_submit, a.store.fleet_counts(), b.store.fleet_counts(),
           a.store.lease_files(), b.metrics.snapshot()["fleet_remote_hits"]]
    a.close()
    b.close()
    return log, ra, rb


def test_fleet_dedup_and_remote_hit_match_jax(tmp_path):
    (tlog, ta, tb), (jlog, ja, jb) = _both(_dedup_and_remote_hit, tmp_path)
    assert tlog == jlog
    assert tlog[1]["fleet_publishes"] == 2     # the duplicate rode one lane
    for t, j in zip(ta + [tb], ja + [jb]):
        assert_matches_jax(t, j)
    assert ta[0].values == ta[1].values
    assert tb.path == "hit" and tb.values == ta[0].values


def _waiter(pkg, tmp_path, abandon):
    a_store = _store(pkg, tmp_path, "A")
    b = _svc(pkg, _store(pkg, tmp_path, "B"), fleet_poll_s=0.01)
    q = _q(pkg, 1.0, 0.6 if abandon else 0.3)
    log = [a_store.claim(q.key())]
    fb = b.submit(q)
    t = threading.Thread(target=b.flush)
    t.start()
    time.sleep(0.3)
    log.append(fb.done())                     # waiting on A's claim
    ref = rr = None
    if abandon:
        a_store.release(q.key())              # A's solve failed: no publish
    else:
        ref = _svc(pkg, M[pkg]["serve"].SolutionStore(capacity=8))
        rr = ref.reference_solve(q)
        a_store.publish(M[pkg]["serve"].make_solution(
            q.cell(), np.asarray(rr.values, dtype=np.float64), q.group(),
            q.key()))
    t.join(60.0)
    log.append(t.is_alive())
    log.append(fb.done())
    if not fb.done():
        b.flush()                             # the election re-runs: B wins
    rb = fb.result(0)
    log += [b.store.fleet_counts(), b.store.lease_files(),
            b.metrics.snapshot()["fleet_remote_hits"]]
    for s in (b, ref):
        if s is not None:
            s.close()
    a_store.close()
    return log, rb, rr


@pytest.mark.parametrize("abandon", [False, True],
                         ids=["winner-publishes", "winner-abandons"])
def test_fleet_claim_loser_matches_jax(tmp_path, abandon):
    (tlog, tb, tr), (jlog, jb, jr) = _both(_waiter, tmp_path, abandon)
    assert tlog == jlog
    assert_matches_jax(tb, jb)
    if abandon:
        assert tlog[3] is False and tb.path in ("cold", "near")
        assert tlog[4]["fleet_publishes"] == 1
    else:
        assert tb.path == "hit" and tlog[-1] == 1
        assert tb.values == tr.values         # the winner's bits


def _failed_lane(pkg, tmp_path):
    serve = M[pkg]["serve"]
    svc = _svc(pkg, _store(pkg, tmp_path, "A"), certify_before_cache=True,
               inject_corrupt_lane={"at_launch": 0, "lane": 0, "field": 0,
                                    "amplitude": 3e-3})
    bad = svc.submit(_q(pkg, 3.0, 0.6))
    mate = svc.submit(_q(pkg, 1.0, 0.3))
    svc.flush()
    with pytest.raises(serve.CertificationFailed):
        bad.result(0)
    peer = _store(pkg, tmp_path, "B")
    log = [svc.store.lease_files(), svc.store.held_leases(),
           svc.store.fleet_counts(), peer.claim(_q(pkg, 3.0, 0.6).key()),
           peer.claim(_q(pkg, 1.0, 0.3).key())]
    peer.release(_q(pkg, 3.0, 0.6).key())
    peer.close()
    svc.close()
    return log, mate.result(0)


def test_fleet_failed_lane_releases_its_claim_as_jax(tmp_path):
    (tlog, tm), (jlog, jm) = _both(_failed_lane, tmp_path)
    assert tlog == jlog
    assert tlog[:2] == [[], []] and tlog[3:] == ["won", "published"]
    assert_matches_jax(tm, jm)


# -- the surrogate answer ------------------------------------------------------

QUERY_CELL = (3.05, 0.55, 0.2)
DONOR_CELLS = [(s, r, 0.2) for s in (2.8, 3.0, 3.2, 3.4)
               for r in (0.45, 0.65)]


def _plane(cell):
    return 0.02 + 0.004 * cell[0] + 0.01 * cell[1]


def _policy(pkg, **over):
    pol = M[pkg]["serve"].SurrogatePolicy(k=6, max_error_bound=0.02,
                                          max_distance=1.0, min_donors=4)
    return pol.replace(**over) if over else pol


def _seed_donors(pkg, svc, group, cells=DONOR_CELLS, cert_level=0):
    for i, c in enumerate(cells):
        packed = np.asarray([_plane(c), 5.0, 0.9, 11.0, 500.0, 4000.0,
                             float(CONVERGED), 0.0, 4500.0, 0.0])
        svc.store.put(M[pkg]["serve"].make_solution(
            c, packed, group, 10_000 + i, cert_level=cert_level))


def _far_donors(pkg, svc, group):
    _seed_donors(pkg, svc, group, cells=[(s, r, 0.2) for s in (7.0, 7.5)
                                         for r in (0.1, 0.3, 0.5)])


def _bad_donors(pkg, svc, group):
    _seed_donors(pkg, svc, group)
    packed = np.asarray([0.5, 5.0, 0.9, 11.0, 500.0, 4000.0,
                         float(CONVERGED), 0.0, 4500.0, 0.0])
    svc.store.put(M[pkg]["serve"].make_solution(
        (3.1, 0.5, 0.2), packed, group, 10_099, cert_level=0))


SURROGATE_KEYS = ("surrogate_hit_rate", "surrogate_escalations",
                  "surrogate_escalation_rate", "surrogate_audits",
                  "surrogate_refinements", "surrogate_audit_failures")


def _surrogate_served(pkg, tmp_path):
    cfg, jp = _obs(pkg, tmp_path)
    svc = _svc(pkg, surrogate=_policy(pkg), obs=cfg)
    q = _q(pkg, *QUERY_CELL)
    _seed_donors(pkg, svc, q.group())
    futs = [svc.submit(q), svc.submit(q)]
    log = [[f.done() for f in futs], svc.store.get(q.key()) is None,
           svc.store.known(), svc.metrics.served["surrogate"]]
    snap = svc.metrics.snapshot()
    log.append({k: snap[k] for k in SURROGATE_KEYS})
    # an uncertified donor set serves nothing by default
    plain = _svc(pkg, surrogate=_policy(pkg))
    _seed_donors(pkg, plain, q.group(), cert_level=-1)
    log.append(plain.submit(q).done())
    plain.close(drain=False)
    svc.close()
    # the keys fold the package token in: each names this query
    log.append([(e["donors"], e["key"] == q.key()) for e in
                M[pkg]["read"](jp, event="SURROGATE_SERVED")])
    return log, [f.result(0) for f in futs]


def test_surrogate_answer_matches_jax(tmp_path):
    (tlog, tres), (jlog, jres) = _both(_surrogate_served, tmp_path)
    assert tlog == jlog
    assert tlog[0] == [True, True] and tlog[1] is True and tlog[5] is False
    for t, j in zip(tres, jres):
        assert (t.path, t.quality, t.status, t.donor_keys) == \
            (j.path, j.quality, j.status, j.donor_keys)
        assert t.path == t.quality == "surrogate"
        assert abs(t.r_star - j.r_star) <= 1e-12
        assert abs(t.surrogate_error_bound - j.surrogate_error_bound) \
            <= 1e-12
        assert t.value("egm_iters") == j.value("egm_iters") == 0.0
    assert abs(tres[0].r_star - _plane(QUERY_CELL)) <= 1e-9


ESCALATIONS = {
    "too_few_donors": (dict(min_donors=10), _seed_donors),
    "donor_too_far": (dict(max_distance=0.3), _far_donors),
    "bound_exceeded": ({}, _bad_donors),
    "audit": (dict(audit_fraction=1.0, audit_seed=7), _seed_donors),
}


def _escalated(pkg, tmp_path, reason):
    over, seeder = ESCALATIONS[reason]
    cfg, jp = _obs(pkg, tmp_path, reason)
    svc = _svc(pkg, surrogate=_policy(pkg, **over), obs=cfg)
    q = _q(pkg, *QUERY_CELL)
    seeder(pkg, svc, q.group())
    fut = svc.submit(q)
    snap = svc.metrics.snapshot()
    log = [fut.done(), {k: snap[k] for k in SURROGATE_KEYS}]
    res = None
    if reason == "audit":
        # the audited escalation resolves through a real solve, cached
        svc.flush()
        res = fut.result(0)
        snap = svc.metrics.snapshot()
        log += [svc.store.get(q.key()) is not None,
                {k: snap[k] for k in SURROGATE_KEYS}]
        svc.close()
        log.append(_events(pkg, jp, "LATTICE_REFINED", ("audit_ok",)))
    else:
        svc.close(drain=False)
    log.append(_events(pkg, jp, "SURROGATE_ESCALATED", ("reason",)))
    return log, res


@pytest.mark.parametrize("reason", list(ESCALATIONS))
def test_surrogate_escalates_as_jax(tmp_path, reason):
    (tlog, tres), (jlog, jres) = _both(_escalated, tmp_path, reason)
    assert tlog == jlog
    assert tlog[0] is False and tlog[-1] == [{"reason": reason}]
    if reason == "audit":
        assert tres.quality == "exact" and tlog[2] is True
        assert tlog[3]["surrogate_audits"] == 1
        assert_matches_jax(tres, jres)


# -- the neighbour prefetch ----------------------------------------------------

def _prefetch(pkg, tmp_path):
    cfg, jp = _obs(pkg, tmp_path)
    svc = _svc(pkg, prefetch_k=2, prefetch_cells=LATTICE, obs=cfg)
    f = svc.submit(_q(pkg, 3.0, 0.6))
    log = [svc.batcher.depth()]
    svc.flush()
    res = [f.result(0)]
    res += [_solve(svc, _q(pkg, 3.0, 0.3)) for _ in range(2)]
    snap = svc.metrics.snapshot()
    log += [snap["serve_prefetch_issued"], snap["serve_prefetch_converted"],
            svc.store.known()]
    svc.close()
    log.append(sorted(tuple(e["cell"]) for e in
                      M[pkg]["read"](jp, event="PREFETCH_ISSUED")))
    return log, res


def test_prefetch_matches_jax(tmp_path):
    (tlog, tres), (jlog, jres) = _both(_prefetch, tmp_path)
    assert tlog == jlog
    assert tlog[0] == 3 and tlog[1:3] == [2, 1]
    assert tlog[-1] == [(3.0, 0.3, 0.2), (3.0, 0.9, 0.2)]
    assert [r.path for r in tres] == ["cold", "hit", "hit"]
    for t, j in zip(tres, jres):
        assert_matches_jax(t, j)


def _prefetch_suppressed(pkg, tmp_path):
    serve = M[pkg]["serve"]
    pol = serve.AdmissionPolicy(max_work=0.9, shed=False, est_batch_s=0.01,
                                class_shares=(1.0, 0.5, 0.01))
    svc = _svc(pkg, prefetch_k=2, prefetch_cells=LATTICE, admission=pol)
    f = svc.submit(_q(pkg, 3.0, 0.6))
    snap = svc.metrics.snapshot()
    log = [snap["serve_prefetch_suppressed"], snap["serve_prefetch_issued"],
           svc.batcher.depth()]
    svc.flush()
    log.append(f.result(0).path)
    svc.close()
    with pytest.raises(ValueError, match="prefetch_cells"):
        _svc(pkg, prefetch_k=2)
    return log


def test_prefetch_suppressed_under_admission_as_jax(tmp_path):
    t, j = _both(_prefetch_suppressed, tmp_path)
    assert t == j and t[:3] == [2, 0, 1]


def _fleet_prefetch(pkg, tmp_path):
    cfg, jp = _obs(pkg, tmp_path)
    svc = _svc(pkg, _store(pkg, tmp_path, "A"), prefetch_k=1,
               prefetch_cells=LATTICE, obs=cfg)
    r = _solve(svc, _q(pkg, 3.0, 0.6))
    svc.flush()                      # drains the speculative neighbour
    log = [svc.store.fleet_counts(), svc.store.lease_files()]
    svc.close()
    pubs = M[pkg]["read"](jp, event="FLEET_PUBLISH")
    # keys fold the package token in: compare the cells they name
    cell_of = {_q(pkg, s, r, sd).key(): (s, r, sd) for s, r, sd in LATTICE}
    log.append([(cell_of[e["key"]], e["speculative"], e["seed"][2])
                for e in pubs])
    return log, r, [e["seed"][:2] for e in pubs]


def test_fleet_prefetch_publish_tagged_speculative_as_jax(tmp_path):
    (tlog, tr, tseeds), (jlog, jr, jseeds) = _both(_fleet_prefetch, tmp_path)
    assert tlog == jlog
    assert [s for _, s, _ in tlog[-1]] == [False, True]
    assert_matches_jax(tr, jr)
    np.testing.assert_allclose(tseeds, jseeds, rtol=0, atol=1e-12)
