"""The port's chaos seams against the JAX package's.

``serve.chaos.ChaosAgent`` is the armable fault surface a ``--chaos``
fleet worker attaches to its shared store (``SolutionStore.set_chaos``),
consulted at four seams: the disk read (a partition window), the
staleness clock (a skewed reclaimer), the publish (a delay that holds the
lease) and the heartbeat (a stall).  Every case runs one sequence through
both packages, each on its own directory, and holds the port's decisions
and ``FLEET_CHAOS_INJECT`` firings equal to JAX's; the store scenarios are
those of the JAX package's ``tests/test_chaos.py``, plus the publish
delay holding the lease.
"""

import threading
import time

import numpy as np
import pytest

import aiyagari_hark_tpu.serve.chaos as jchaos
import aiyagari_hark_tpu.serve.store as jstore
import aiyagari_hark_tpu_torch.serve.chaos as tchaos
import aiyagari_hark_tpu_torch.serve.store as tstore
from aiyagari_hark_tpu.scenarios.aiyagari import AIYAGARI_SCHEMA as JSCHEMA
from aiyagari_hark_tpu_torch.scenarios.aiyagari import \
    AIYAGARI_SCHEMA as TSCHEMA

PKGS = {"jax": (jchaos, jstore, JSCHEMA), "torch": (tchaos, tstore, TSCHEMA)}


class _RecObs:
    """Event recorder standing in for an obs scope."""

    def __init__(self):
        self.events = []

    def event(self, etype, **fields):
        self.events.append((etype, dict(fields)))

    def of(self, etype):
        return [f for t, f in self.events if t == etype]


def _both(case, tmp_path=None):
    out = {}
    for name, mods in PKGS.items():
        args = mods if tmp_path is None else mods + (tmp_path / name,)
        out[name] = case(*args)
    assert out["torch"] == out["jax"]
    return out["torch"]


# -- the agent's arm, fire and disarm decisions -------------------------------

def _agent_trace(chaos, _store, _schema):
    obs = _RecObs()
    a = chaos.ChaosAgent(obs=obs, owner="w0")
    t = [a.arm({"slow_publish_s": 1.5, "slow_cells": [(1.0, 0.0, 0.2)]})]
    t.append(a.arm({"heartbeat_stall": True}))          # partial arm
    t += [a.publish_delay_s((3.0, 0.3, 0.2)),          # not armed
          a.publish_delay_s((1.0, 0.0, 0.2)),
          a.heartbeat_stalled(), a.heartbeat_stalled()]
    t.append(a.arm({"partition_reads": 2}))
    t += [a.read_fault(7), a.read_fault(7), a.read_fault(7)]
    t.append(a.skew_now() is None)
    t.append(a.arm({"lease_skew_s": 120.0})["lease_skew_s"])
    now = a.skew_now()
    t += [now - time.time() > 100.0, a.skew_now() is not None]
    t.append(a.arm({"slow_publish_s": 0.0, "heartbeat_stall": False,
                    "lease_skew_s": 0.0}))
    t += [a.heartbeat_stalled(), a.skew_now(),
          a.publish_delay_s((1.0, 0.0, 0.2))]
    t.append([(f["drill"], f["owner"]) for f in obs.of("FLEET_CHAOS_INJECT")])
    t.append(a.armed())
    return t


def test_agent_decisions_and_firings_match_jax():
    t = _both(_agent_trace)
    assert t[-1]["fired"] == 5
    assert [d for d, _ in t[-2]] == ["slow_publish", "heartbeat_stall",
                                     "partition", "partition", "clock_skew"]


def test_disk_fault_arms_the_checkpoint_writers_as_jax(tmp_path):
    """``disk_fault`` arms the port's own ``utils.checkpoint`` seam (the
    disk-full-publish drill): the next matching write raises ENOSPC."""
    def case(chaos, _store, _schema, d):
        import importlib
        ck = importlib.import_module(
            chaos.__name__.replace("serve.chaos", "utils.checkpoint"))
        d.mkdir()
        a = chaos.ChaosAgent()
        a.arm({"disk_fault": {"op": "save_pytree", "kind": "ENOSPC",
                              "count": 1, "match": "sol_"}})
        out = []
        for name in ("sol_a.npz", "sol_b.npz"):
            try:
                ck.save_pytree(str(d / name), (np.zeros(2), np.ones(1)))
                out.append("ok")
            except OSError as e:
                out.append(e.errno)
        a.arm({"disk_fault": None})
        return out

    import errno
    assert _both(case, tmp_path) == [errno.ENOSPC, "ok"]


# -- the store under each fault -----------------------------------------------

def _row(schema, key):
    rng = np.random.default_rng(key)
    row = rng.standard_normal(len(schema.fields))
    row[schema.idx(schema.status)] = 0.0
    row[schema.idx(schema.root)] = 0.01 + key * 1e-4
    return row


def _mk(store, d, owner, ttl=30.0, chaos=None):
    s = store.SolutionStore(disk_path=str(d / "shared"), shared=True,
                            lease_ttl_s=ttl, owner=owner, capacity=8)
    if chaos is not None:
        s.set_chaos(chaos)
    return s


def test_partition_read_degrades_to_a_miss_without_eviction_as_jax(
        tmp_path):
    def case(chaos, store, schema, d):
        key = 42
        writer = _mk(store, d, "w0")
        t = [writer.claim(key)]
        writer.publish(store.make_solution((1.0 + key, 0.5, 0.2),
                                           _row(schema, key), group=777,
                                           key=key, schema=schema))
        writer.close()
        agent = chaos.ChaosAgent(owner="w1")
        agent.arm({"partition_reads": 1})
        reader = _mk(store, d, "w1", chaos=agent)
        t.append(reader.get(key) is None)               # the window
        t.append(reader.fleet_counts()["fleet_backend_faults"])
        t.append(reader.integrity_counts()["store_corrupt_evictions"])
        got = reader.get(key)                           # the very next read
        t.append(np.asarray(got.packed).tolist())
        reader.close()
        return t

    t = _both(case, tmp_path)
    assert t[:4] == ["won", True, 1, 0]


def test_heartbeat_stall_loses_the_lease_and_is_detected_as_jax(tmp_path):
    def case(chaos, store, _schema, d):
        key = 9
        agent = chaos.ChaosAgent(owner="w0")
        agent.arm({"heartbeat_stall": True})
        zombie = _mk(store, d, "w0", ttl=0.4, chaos=agent)
        t = [zombie.claim(key)]
        time.sleep(0.7)                                 # aged, unbeaten
        peer = _mk(store, d, "w1", ttl=0.4)
        t += [peer.reclaim_if_stale(key), peer.claim(key)]
        agent.arm({"heartbeat_stall": False})           # the zombie wakes
        deadline = time.time() + 5.0
        while (time.time() < deadline
               and zombie.heartbeat_health()["lost_leases"] < 1):
            time.sleep(0.05)
        t += [zombie.heartbeat_health()["lost_leases"], zombie.held_leases()]
        zombie.release(key)                             # owner-checked away
        t.append(peer.lease_present(key))
        peer.release(key)
        zombie.close()
        peer.close()
        return t

    assert _both(case, tmp_path) == ["won", True, "won", 1, [], True]


def test_skewed_clock_forces_the_duplicated_election_as_jax(tmp_path):
    def case(chaos, store, _schema, d):
        key = 5
        holder = _mk(store, d, "w0")
        t = [holder.claim(key)]                         # fresh, TTL 30
        obs = _RecObs()
        agent = chaos.ChaosAgent(obs=obs, owner="w1")
        agent.arm({"lease_skew_s": 200.0})
        skewed = _mk(store, d, "w1", chaos=agent)
        t += [skewed.claim(key),                        # stole it
              skewed.fleet_counts()["fleet_lease_reclaims"],
              [f["drill"] for f in obs.of("FLEET_CHAOS_INJECT")]]
        holder.close()
        skewed.close()
        return t

    assert _both(case, tmp_path) == ["won", "won", 1, ["clock_skew"]]


def test_publish_delay_holds_the_lease_as_jax(tmp_path):
    """An armed publish delay keeps the winner's lease held (and the
    entry unpublished) for the delay: the kill and stall drills' window.
    A peer probing mid-delay sees the lease and no entry; after the
    publish, the entry and no lease."""
    def case(chaos, store, schema, d):
        key = 17
        cell = (2.0, 0.4, 0.2)
        obs = _RecObs()
        agent = chaos.ChaosAgent(obs=obs, owner="w0")
        agent.arm({"slow_publish_s": 2.0, "slow_cells": [cell]})
        winner = _mk(store, d, "w0", chaos=agent)
        peer = _mk(store, d, "w1")
        t = [winner.claim(key)]
        done = threading.Event()

        def publish():
            winner.publish(store.make_solution(
                cell, _row(schema, key), group=3, key=key, schema=schema))
            done.set()

        th = threading.Thread(target=publish)
        t0 = time.monotonic()
        th.start()
        time.sleep(0.3)
        t += [peer.lease_present(key), peer.get(key) is None, done.is_set(),
              peer.claim(key)]
        th.join(10)
        t += [time.monotonic() - t0 >= 2.0, peer.lease_present(key),
              peer.get(key) is not None,
              [(f["drill"], f["delay_s"])
               for f in obs.of("FLEET_CHAOS_INJECT")]]
        winner.close()
        peer.close()
        return t

    assert _both(case, tmp_path) == [
        "won", True, True, False, "lost", True, False, True,
        [("slow_publish", 2.0)]]


@pytest.mark.parametrize("name", sorted(PKGS))
def test_set_chaos_none_detaches(name, tmp_path):
    chaos, store, _schema = PKGS[name]
    s = _mk(store, tmp_path, "w0", chaos=chaos.ChaosAgent())
    s.set_chaos(None)
    assert s._chaos_now() is None
    s.close()
