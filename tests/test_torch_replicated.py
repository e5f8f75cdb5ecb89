"""The port's quorum-replicated lease backend against the JAX package's.

``serve.replicated.ReplicatedCASBackend`` is host code in both packages:
a client over three loopback CAS replicas that elects by majority-ack
conditional writes and reads by versioned quorum.  Every case below runs
the same sequence of operations through the JAX client over JAX replicas
and through the port's client over the port's replicas, and holds the
port's decisions, counters and journaled events equal to JAX's: the
``replicated-cas`` cases of the JAX lease conformance suite, read-repair
of a replica that missed a write, anti-entropy resync of a rejoining
replica, the typed refusal of a minority, and the election raced by two
processes over three of the port's replicas.  ``ReplicaSet`` spawns the
port's own replica process (``python -m
aiyagari_hark_tpu_torch.serve.lease``), whose WAL recovers its record map
after a SIGKILL.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

import aiyagari_hark_tpu.serve.lease as jlease
import aiyagari_hark_tpu.serve.replicated as jrep
import aiyagari_hark_tpu_torch.serve.lease as tlease
import aiyagari_hark_tpu_torch.serve.replicated as trep
from aiyagari_hark_tpu_torch.obs import read_journal
from aiyagari_hark_tpu_torch.utils.fingerprint import fingerprint_hex

PKGS = {"jax": (jlease, jrep), "torch": (tlease, trep)}
KEY = -7_654_321_987
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _RecObs:
    """Event recorder standing in for an obs scope."""

    def __init__(self):
        self.events = []

    def event(self, etype, **fields):
        self.events.append((etype, dict(fields)))

    def of(self, etype):
        return [f for t, f in self.events if t == etype]


class _Quorum:
    """Three in-process CAS replicas of one package and its quorum client
    (with an event recorder attached)."""

    def __init__(self, name, skew_tolerance_s=0.0):
        lease, rep = PKGS[name]
        self.srvs = [lease.CASServer(skew_tolerance_s=skew_tolerance_s)
                     .start() for _ in range(3)]
        self.addresses = [s.address for s in self.srvs]
        self.b = rep.ReplicatedCASBackend(
            self.addresses, skew_tolerance_s=skew_tolerance_s)
        self.obs = _RecObs()
        self.b.attach_obs(self.obs)
        self.lease, self.rep = lease, rep

    def client(self):
        c = self.rep.ReplicatedCASBackend(self.addresses)
        c.attach_obs(self.obs)
        return c

    def close(self):
        self.b.close()
        for s in self.srvs:
            s.stop()


def _both(case, **kw):
    out = {}
    for name in PKGS:
        q = _Quorum(name, **kw)
        try:
            out[name] = case(q)
        finally:
            q.close()
    assert out["torch"] == out["jax"]
    return out["torch"]


# -- the conformance cases, decided as JAX decides them -----------------------

def _sequential(q):
    b = q.b
    return [b.try_acquire(KEY, "a"), b.try_acquire(KEY, "b"),
            b.try_acquire(KEY, "a"), b.owner_of(KEY), b.list_keys(),
            b.release(KEY, owner="a"), b.list_keys()]


def _burst(q):
    wins, barrier = [], threading.Barrier(8)

    def racer(i):
        barrier.wait()
        if q.b.try_acquire(KEY, f"w{i}"):
            wins.append(i)

    threads = [threading.Thread(target=racer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    return [len(wins), q.b.owner_of(KEY) == f"w{wins[0]}"]


def _heartbeat(q):
    b = q.b
    t = [b.try_acquire(KEY, "a")]
    b.backdate(KEY, 30.0)
    t += [b.age_s(KEY) >= 29.0, b.heartbeat(KEY, "a"), b.age_s(KEY) < 5.0,
          b.break_stale(KEY, ttl_s=10.0), b.owner_of(KEY)]
    return t


def _ttl_reclaim(q):
    b = q.b
    t = [b.try_acquire(KEY, "dead"), b.break_stale(KEY, ttl_s=10.0)]
    b.backdate(KEY, 30.0)
    return t + [b.break_stale(KEY, ttl_s=10.0), b.list_keys(),
                b.try_acquire(KEY, "heir"), b.owner_of(KEY)]


def _reclaim_vs_heartbeat(q):
    b = q.b
    t = [b.try_acquire(KEY, "a")]
    b.backdate(KEY, 30.0)
    return t + [b.age_s(KEY) > 10.0, b.heartbeat(KEY, "a"),
                b.break_stale(KEY, ttl_s=10.0), b.owner_of(KEY)]


def _owner_checked(q):
    b = q.b
    return [b.try_acquire(KEY, "a"), b.release(KEY, owner="b"),
            b.heartbeat(KEY, "b"), b.owner_of(KEY),
            b.release(KEY, owner="a"), b.try_acquire(KEY, "c"),
            b.release(KEY)]


def _late_release(q):
    b = q.b
    t = [b.try_acquire(KEY, "a")]
    b.backdate(KEY, 30.0)
    return t + [b.break_stale(KEY, ttl_s=10.0), b.try_acquire(KEY, "b"),
                b.release(KEY, owner="a"), b.heartbeat(KEY, "a"),
                b.owner_of(KEY)]


def _backwards_clock(q):
    b = q.b
    past = time.time() - 3600.0
    return [b.try_acquire(KEY, "a"), b.age_s(KEY, now=past),
            b.break_stale(KEY, ttl_s=0.001, now=past), b.owner_of(KEY)]


def _absent(q):
    b = q.b
    return [b.age_s(KEY), b.owner_of(KEY), b.release(KEY),
            b.heartbeat(KEY, "a"), b.break_stale(KEY, ttl_s=0.0),
            b.list_keys()]


def _lease_names(q):
    b = q.b
    return [b.try_acquire(KEY, "a"),
            [os.path.basename(n) for n in b.lease_names()]]


CASES = {"sequential": _sequential, "threaded_burst": _burst,
         "heartbeat": _heartbeat, "ttl_reclaim": _ttl_reclaim,
         "reclaim_vs_heartbeat": _reclaim_vs_heartbeat,
         "owner_checked": _owner_checked, "late_release": _late_release,
         "backwards_clock": _backwards_clock, "absent_key": _absent,
         "lease_names": _lease_names}


@pytest.mark.parametrize("case", sorted(CASES))
def test_replicated_conformance_decides_as_jax(case):
    trace = _both(CASES[case])
    expected_head = {"sequential": [True, False, False, "a", [KEY], True, []],
                     "threaded_burst": [1, True],
                     "absent_key": [None, None, False, False, False, []],
                     "lease_names": [True,
                                     [f"lease_{fingerprint_hex(KEY)}.lease"]]}
    if case in expected_head:
        assert trace == expected_head[case]


def test_skew_tolerance_widens_staleness_as_jax():
    def case(q):
        b = q.b
        now = time.time()
        return [b.try_acquire(KEY, "a"),
                b.break_stale(KEY, ttl_s=1.0, now=now + 1.0 + 3.0),
                b.owner_of(KEY),
                b.break_stale(KEY, ttl_s=1.0, now=now + 1.0 + 60.0),
                b.list_keys()]

    assert _both(case, skew_tolerance_s=5.0) == [True, False, "a", True, []]


# -- read-repair, resync, quorum loss -----------------------------------------

def _dumps(q):
    out = []
    for a in q.addresses:
        c = q.lease.LoopbackCASBackend(a)
        out.append([[k, o, v] for k, o, _t, v in c.dump()])
        c.close()
    return out


def test_read_repair_heals_a_replica_that_missed_a_write_as_jax():
    """Replica 2 is partitioned while the key is acquired; a second
    client's quorum read finds it behind the winner and pushes the
    record (one REPLICA_RESYNC, mode read_repair)."""
    def case(q):
        q.b.set_partition([2])
        won = q.b.try_acquire(KEY, "a")
        before = _dumps(q)
        reader = q.client()
        owner = reader.owner_of(KEY)
        repairs = reader.read_repairs
        reader.close()
        events = [(f["mode"], f["version"], len(f["replicas"]))
                  for f in q.obs.of("REPLICA_RESYNC")]
        return [won, before, owner, repairs, events, _dumps(q)]

    t = _both(case)
    assert t[0] is True and t[2] == "a" and t[3] == 1
    assert t[4] == [("read_repair", 1, 1)]
    assert t[1][2] == [] and t[5][2] == t[5][0]


def test_anti_entropy_resyncs_a_rejoining_replica_as_jax():
    """Keys acquired while replica 2 is unreachable mark it suspect; the
    first operation after the heal resyncs its whole map (one
    REPLICA_RESYNC, mode anti_entropy, every missing record pushed)."""
    def case(q):
        q.b.set_partition([2])
        won = [q.b.try_acquire(k, f"o{k}") for k in (1, 2, 3)]
        q.b.release(2, owner="o2")
        q.b.set_partition([])
        owner = q.b.owner_of(1)
        events = [(f["mode"], f.get("pushed"), f.get("keys"))
                  for f in q.obs.of("REPLICA_RESYNC")]
        return [won, owner, q.b.resyncs, events, _dumps(q)]

    t = _both(case)
    assert t[:4] == [[True] * 3, "o1", 1, [("anti_entropy", 3, 3)]]
    assert t[4][0] == t[4][1] == t[4][2]


def test_minority_refuses_typed_and_journals_quorum_lost_once_as_jax():
    def case(q):
        q.b.set_partition([1, 2])
        raised = []
        for _ in range(2):
            try:
                q.b.try_acquire(KEY, "a")
            except q.lease.CoordinationUnavailable as e:
                raised.append(type(e).__name__)
        lost = [(f["op"], f["reachable"], f["needed"])
                for f in q.obs.of("QUORUM_LOST")]
        q.b.set_partition([])
        return [raised, lost, q.b.try_acquire(KEY, "a"), q.b.reachable()]

    assert _both(case) == [["CoordinationUnavailable"] * 2,
                           [("get", 1, 2)], True, 3]


def test_make_backend_builds_the_port_quorum_client():
    srvs = [tlease.CASServer().start() for _ in range(3)]
    try:
        b = tlease.make_backend("replicated:" + ",".join(
            s.address for s in srvs))
        assert isinstance(b, trep.ReplicatedCASBackend)
        assert (b.n, b.majority, b.name) == (3, 2, "replicated-cas")
        assert b.try_acquire(KEY, "a") and b.owner_of(KEY) == "a"
        assert all(s.backend.owner_of(KEY) == "a" for s in srvs)
        b.close()
    finally:
        for s in srvs:
            s.stop()
    with pytest.raises(ValueError, match="odd replica count"):
        trep.ReplicatedCASBackend(["127.0.0.1:1", "127.0.0.1:2"])


# -- two real processes race one election over three port replicas ------------

_CHILD = r"""
import json, sys
from aiyagari_hark_tpu_torch.serve.lease import make_backend

spec, owner, n_keys, out = sys.argv[1:5]
b = make_backend(spec)
wins = [k for k in range(1, int(n_keys) + 1) if b.try_acquire(k, owner)]
b.close()
with open(out, "w") as f:   # atomic-ok: test child's private result file
    json.dump({"wins": wins}, f)
"""


def test_two_process_claim_race_over_port_replicas(tmp_path):
    srvs = [tlease.CASServer().start() for _ in range(3)]
    try:
        spec = "replicated:" + ",".join(s.address for s in srvs)
        outs = [str(tmp_path / f"race{i}.json") for i in range(2)]
        env = dict(os.environ, PYTHONPATH=ROOT)
        procs = [subprocess.Popen(
            [sys.executable, "-c", _CHILD, spec, f"w{i}", "24", outs[i]],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True) for i in range(2)]
        wins = []
        for i, p in enumerate(procs):
            _, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"child {i} failed:\n{err}"
            with open(outs[i]) as f:
                wins += json.load(f)["wins"]
        assert sorted(wins) == list(range(1, 25))      # each key once
        for s in srvs:
            assert s.backend.list_keys() == list(range(1, 25))
    finally:
        for s in srvs:
            s.stop()


# -- the port's replica processes ---------------------------------------------

def test_replica_set_runs_the_port_replica_and_recovers_its_wal(tmp_path):
    """``ReplicaSet`` spawns ``python -m aiyagari_hark_tpu_torch.serve.
    lease``; a SIGKILLed replica restarts at the same address and replays
    its WAL (``WAL_REPLAY`` in its journal) to its exact record map."""
    with trep.ReplicaSet(str(tmp_path / "rs"), n=3,
                         snapshot_every=4) as rs:
        cmd = " ".join(rs.procs[0].args)
        assert "-m aiyagari_hark_tpu_torch.serve.lease" in cmd
        b = tlease.make_backend(rs.spec)
        assert [b.try_acquire(k, f"o{k}") for k in range(6)] == [True] * 6
        assert b.release(3, owner="o3")
        c = tlease.LoopbackCASBackend(rs.addresses()[2])
        before = c.dump()
        c.close()
        port = rs.ports[2]
        rs.kill(2, signal.SIGKILL)
        assert rs.returncode(2) == -int(signal.SIGKILL)
        rs.restart(2)
        assert rs.ports[2] == port and rs.alive(2)
        c = tlease.LoopbackCASBackend(rs.addresses()[2])
        assert c.dump() == before
        c.close()
        assert read_journal(rs.journals[2], event="WAL_REPLAY")
        assert b.list_keys() == [0, 1, 2, 4, 5]
        b.close()
    assert not any(rs.alive(i) for i in range(3))


def test_torn_tail_is_dropped_so_a_second_crash_recovers(tmp_path):
    """A replica restarted over a torn WAL tail, written to, then killed
    again before a compaction: the port rewrote its WAL to the valid
    prefix at the first recovery, so the second recovers every record;
    JAX's appends after the torn bytes on their line and refuses the
    mid-log record at the second (ROADMAP Queue 3 item 16)."""
    import warnings

    import aiyagari_hark_tpu.serve.wal as jwal
    import aiyagari_hark_tpu_torch.serve.wal as twal

    out = {}
    for name, wal in (("jax", jwal), ("torch", twal)):
        d = str(tmp_path / name)
        clock = iter(float(i) for i in range(100)).__next__
        b = wal.DurableCASBackend(d, clock=clock, snapshot_every=64)
        for key in range(3):
            assert b.try_acquire(key, f"o{key}")
        with open(os.path.join(d, wal.WAL_NAME), "ab") as f:  # atomic-ok: test writes the torn tail
            f.write(b'{"seq":999999999,"k":1,"o":"torn')
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            reborn = wal.DurableCASBackend(d, clock=clock,
                                           snapshot_every=64)
        assert reborn.release(1, owner="o1")
        assert reborn.try_acquire(7, "o7")
        state = reborn.dump()
        try:
            out[name] = wal.DurableCASBackend(d, snapshot_every=64).dump() \
                == state
        except wal.WALCorruptionError:
            out[name] = "refused"
    assert out == {"jax": "refused", "torch": True}
