"""The port's ``EquilibriumService`` against the JAX package's, on the CPU
in float64 at JAX's serve widths (``bench.py``'s serve smoke:
``a_count=10, dist_count=32, labor_states=3, r_tol=1e-5``).

Against JAX, the same query sequences under one injected clock, both
services with ``start_worker=False``: every answer's ``path``, status and
``bisect_iters`` equal; r* within ``100 * r_tol`` pct and capital to
``rtol=1e-6`` (``tests/test_torch_sweep_engine.py``'s bounds); the
distribution steps within 0.07 % (the summation-order gap of ROADMAP
Queue 3 item 4); the typed error of every failed future, the journal's
serve events and the metrics snapshot's keys equal.  Covered: the
Aiyagari scenario (cold, exact hit, near), Huggett with certification,
one Epstein-Zin cell (cold only).

The port's own bit contract, which its lane-independent solver holds
bitwise: a served lane equals a C=1 launch with the same seed in every
packed field, at every batch packing and padding; a NaN lane fails only
its own future and is never cached; the threaded worker serves the bits
of ``flush()``.  Also: the store's package keys (a JAX-written directory
serves no exact hit and loses no file), a corrupted disk entry evicted
and re-solved, and what raises until ROADMAP item 6 lands.
"""

import os
import threading
import warnings

import numpy as np
import pytest
import torch

import aiyagari_hark_tpu.serve as jserve
import aiyagari_hark_tpu.verify.inject as jinject
import aiyagari_hark_tpu_torch.serve as tserve
import aiyagari_hark_tpu_torch.verify.inject as tinject
from aiyagari_hark_tpu.obs import ObsConfig as JObsConfig
from aiyagari_hark_tpu.obs import read_journal as jread_journal
from aiyagari_hark_tpu_torch.obs import ObsConfig as TObsConfig
from aiyagari_hark_tpu_torch.obs import read_journal as tread_journal
from aiyagari_hark_tpu_torch.solver_health import NONFINITE, is_failure

torch.set_num_threads(1)
F64 = torch.float64
KW = dict(a_count=10, dist_count=32, labor_states=3, r_tol=1e-5,
          max_bisect=24)
HKW = dict(a_count=12, dist_count=48, labor_states=3, r_tol=1e-5,
           max_bisect=20, egm_tol=1e-5, dist_tol=1e-9, borrow_limit=-2.0)
EKW = dict(a_count=10, dist_count=32, labor_states=3, r_tol=1e-4,
           max_bisect=12, egm_tol=1e-5, dist_tol=1e-8, ez_rho=2.0)
CELLS = [(1.0, 0.3), (3.0, 0.6), (5.0, 0.0), (3.0, 0.9)]
DIST_GAP = 7e-4          # distribution steps: the summation-order gap
PKG = {"jax": (jserve, np.float64, {}),
       "torch": (tserve, F64, {"device": "cpu"})}


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _svc(pkg, **kw):
    mod, _, extra = PKG[pkg]
    base = dict(start_worker=False, max_batch=4, max_wait_s=60.0,
                ladder=(1, 2, 4), clock=FakeClock())
    base.update(extra)
    base.update(kw)
    return mod.EquilibriumService(**base)


def _q(pkg, s, r, sd=0.2, model=KW, **kw):
    mod, dt, _ = PKG[pkg]
    return mod.make_query(s, r, labor_sd=sd, dtype=dt, **model, **kw)


def _wave(pkg, svc, cells, flush=True, model=KW, **kw):
    futs = [svc.submit(_q(pkg, s, r, model=model, **kw)) for s, r in cells]
    if flush:
        svc.flush()
    return [f.result(0) for f in futs]


def assert_matches_jax(t, j, r_tol=KW["r_tol"]):
    """One port answer against JAX's: path, status and trips equal, r*
    within 100 r_tol pct, capital to 1e-6, inner steps within tolerance."""
    assert (t.path, t.status, t.bisect_iters, t.scenario) == \
        (j.path, j.status, j.bisect_iters, j.scenario)
    assert t.fields == j.fields
    assert abs(t.r_star - j.r_star) * 100.0 <= 100.0 * r_tol
    if np.isfinite(j.capital):
        np.testing.assert_allclose(t.capital, j.capital, rtol=1e-6)
    np.testing.assert_allclose(t.egm_iters, j.egm_iters, rtol=DIST_GAP)
    np.testing.assert_allclose(t.dist_iters, j.dist_iters, rtol=DIST_GAP)
    assert (t.bracket_init is None) == (j.bracket_init is None)
    if t.bracket_init is not None:
        assert t.bracket_init[2] == j.bracket_init[2]


def _aiyagari_replay(pkg, tmp_path):
    """Cold wave, shuffled exact-hit wave, neighbour wave at rho - 0.05,
    journaled; returns (results, journal events, metrics snapshot)."""
    cfg = (JObsConfig if pkg == "jax" else TObsConfig)(
        enabled=True, journal_path=str(tmp_path / f"{pkg}.jsonl"))
    svc = _svc(pkg, obs=cfg)
    out = _wave(pkg, svc, CELLS)
    order = np.random.default_rng(0).permutation(len(CELLS))
    out += _wave(pkg, svc, [CELLS[int(i)] for i in order], flush=False)
    out += _wave(pkg, svc, [(s, r - 0.05) for s, r in CELLS])
    snap = svc.metrics.snapshot()
    svc.close()
    read = jread_journal if pkg == "jax" else tread_journal
    events = [e["event"] for e in read(str(tmp_path / f"{pkg}.jsonl"))]
    return out, events, snap, order


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("replay")
    return {pkg: _aiyagari_replay(pkg, tmp) for pkg in ("jax", "torch")}


# -- against JAX ------------------------------------------------------------------

def test_aiyagari_cold_hit_near_match_jax(replay):
    t, j = replay["torch"][0], replay["jax"][0]
    assert [r.path for r in t] == ["cold"] * 4 + ["hit"] * 4 + ["near"] * 4
    for a, b in zip(t, j):
        assert_matches_jax(a, b)
    # the exact hits are the cold wave's bits, in the shuffled order
    order = replay["torch"][3]
    for pos, i in enumerate(order):
        assert t[4 + pos].values == t[int(i)].values
    # the warm seeds cut bisection trips, as in JAX
    assert sum(r.bisect_iters for r in t[8:]) < sum(
        r.bisect_iters for r in t[:4])


def test_journal_events_and_metrics_snapshot_match_jax(replay):
    (_, tev, tsnap, _), (_, jev, jsnap, _) = replay["torch"], replay["jax"]
    assert tev == jev
    assert tev[0] == "RUN_START" and tev[-1] == "RUN_END"
    assert list(tsnap) == list(jsnap)
    for key in ("serve_requests", "serve_hit_rate", "serve_near_rate",
                "serve_cold_rate", "serve_batches", "serve_failures",
                "serve_batch_occupancy", "serve_queue_depth_peak",
                "serve_scenarios"):
        assert tsnap[key] == jsnap[key], key
    # nothing compiles on the CPU: no kernel library is built or loaded
    assert tsnap["serve_compiles"] == 0


def test_huggett_served_with_certification_matches_jax():
    cells = [(1.5, 0.3), (3.0, 0.6)]
    out = {}
    for pkg in ("jax", "torch"):
        svc = _svc(pkg, donor_cutoff=1.0, certify_before_cache=True)
        res = _wave(pkg, svc, cells, model=HKW, scenario="huggett")
        res += _wave(pkg, svc, cells, flush=False, model=HKW,
                     scenario="huggett")
        res += _wave(pkg, svc, [(s, r + 0.05) for s, r in cells],
                     model=HKW, scenario="huggett")
        out[pkg] = (res, svc)
    (t, tsvc), (j, _) = out["torch"], out["jax"]
    assert [r.path for r in t][:4] == ["cold", "cold", "hit", "hit"]
    assert "near" in [r.path for r in t[4:]]
    for a, b in zip(t, j):
        assert_matches_jax(a, b, r_tol=HKW["r_tol"])
        assert a.cert_level == b.cert_level and a.cert_level <= 1
        np.testing.assert_allclose(a.value("borrower_share"),
                                   b.value("borrower_share"), rtol=1e-5)
    # served == a C=1 launch with the same seed, cold and near
    for res, (s, r) in zip(t[:2] + t[4:], cells + [(s, r + 0.05)
                                                   for s, r in cells]):
        ref = tsvc.reference_solve(
            _q("torch", s, r, model=HKW, scenario="huggett"),
            bracket_init=res.bracket_init)
        assert ref.values == res.values
    tsvc.close()


def test_epstein_zin_cold_cell_matches_jax():
    t, j = (_wave(pkg, _svc(pkg), [(3.0, 0.6)], model=EKW,
                  scenario="epstein_zin")[0] for pkg in ("torch", "jax"))
    assert t.path == j.path == "cold" and t.bracket_init is None
    assert_matches_jax(t, j, r_tol=EKW["r_tol"])


# -- the port's own bit contract ---------------------------------------------------

def _bits(res):
    return np.asarray(res.values, dtype=np.float64).view(np.uint64)


def test_served_lane_equals_c1_launch_in_every_field(replay):
    t = replay["torch"][0]
    svc = _svc("torch")
    for res, (s, r) in ((t[0], CELLS[0]), (t[3], CELLS[3]),
                        (t[9], (CELLS[1][0], CELLS[1][1] - 0.05)),
                        (t[10], (CELLS[2][0], CELLS[2][1] - 0.05))):
        ref = svc.reference_solve(_q("torch", s, r),
                                  bracket_init=res.bracket_init)
        assert np.array_equal(_bits(ref), _bits(res))
    svc.close()


def test_bits_do_not_depend_on_packing_or_padding(replay):
    """The cold wave again in reverse order as batches of 3 + 1, and one
    cell at a time on a ladder of 1: the same bits (``donor_cutoff=0``
    keeps every lane cold)."""
    cold = replay["torch"][0][:4]
    rev = _svc("torch", max_batch=3, ladder=(1, 3), donor_cutoff=0.0)
    got = _wave("torch", rev, CELLS[::-1])[::-1]
    single = _svc("torch", max_batch=1, ladder=(1,), donor_cutoff=0.0)
    got1 = [_wave("torch", single, [c])[0] for c in CELLS[:2]]
    for a, b in zip(got + got1, cold + cold[:2]):
        assert a.path == "cold" and np.array_equal(_bits(a), _bits(b))
    assert rev.metrics.snapshot()["serve_batches"] == 2
    rev.close()
    single.close()


def test_nan_lane_fails_only_its_future_and_is_never_cached(replay):
    cold = replay["torch"][0][:4]
    errs = {}
    for pkg in ("jax", "torch"):
        svc = _svc(pkg, inject_fault_mode="nan")
        futs = [svc.submit(_q(pkg, s, r,
                              fault_iter=0 if i == 1 else None))
                for i, (s, r) in enumerate(CELLS[:3])]
        assert svc.flush() == 1
        with pytest.raises(tserve.EquilibriumSolveFailed if pkg == "torch"
                           else jserve.EquilibriumSolveFailed) as ei:
            futs[1].result(0)
        errs[pkg] = (type(ei.value).__name__, ei.value.status,
                     ei.value.cell)
        assert svc.store.get(_q(pkg, *CELLS[1]).key()) is None
        assert svc.metrics.failures == 1
        if pkg == "torch":
            for i in (0, 2):
                assert np.array_equal(_bits(futs[i].result(0)),
                                      _bits(cold[i]))
        svc.close()
    assert errs["torch"] == errs["jax"]
    assert errs["torch"][1] == NONFINITE and is_failure(NONFINITE)


def test_threaded_worker_serves_the_bits_of_flush(replay):
    cold = replay["torch"][0][:4]
    # donor_cutoff=0: every lane cold whatever batches the worker forms
    svc = tserve.EquilibriumService(start_worker=True, max_batch=4,
                                    max_wait_s=0.05, ladder=(1, 2, 4),
                                    donor_cutoff=0.0, device="cpu")
    got = [None] * 4

    def client(i):
        got[i] = svc.submit(_q("torch", *CELLS[i])).result(120)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(180)
    svc.close()
    for a, b in zip(got, cold):
        assert a.path == "cold" and np.array_equal(_bits(a), _bits(b))


def test_certify_before_cache_and_corrupt_lane_match_jax():
    out = {}
    for pkg in ("jax", "torch"):
        mod = PKG[pkg][0]
        svc = _svc(pkg, certify_before_cache=True,
                   inject_corrupt_lane={"at_launch": 0, "lane": 0,
                                        "field": 0, "amplitude": 3e-3})
        bad = svc.submit(_q(pkg, *CELLS[1]))
        mate = svc.submit(_q(pkg, *CELLS[0]))
        svc.flush()
        with pytest.raises(mod.CertificationFailed) as ei:
            bad.result(0)
        assert ei.value.certificate.failed
        assert svc.store.get(ei.value.key) is None
        clean = svc.query(*CELLS[1], dtype=PKG[pkg][1], **KW)
        snap = svc.metrics.snapshot()
        out[pkg] = (ei.value.cell, mate.result(0).cert_level,
                    clean.path, clean.cert_level, svc.store.known(),
                    snap["serve_failed_certificates"],
                    snap["serve_certified"], mate.result(0), clean)
        svc.close()
    t, j = out["torch"], out["jax"]
    assert t[:7] == j[:7]
    assert t[1] == 0 and t[3] == 0            # CERTIFIED
    assert_matches_jax(t[7], j[7])
    assert_matches_jax(t[8], j[8])


@pytest.mark.parametrize("mode", ["perturb", "truncate", "zero"])
def test_corrupt_disk_entry_is_evicted_and_resolved_as_jax(tmp_path, mode):
    out = {}
    for pkg, inject in (("jax", jinject), ("torch", tinject)):
        d = str(tmp_path / pkg)
        first = _svc(pkg, disk_path=d)
        base = _wave(pkg, first, CELLS[:2])
        first.close()
        inject.corrupt_store_entry(d, key=base[1].key, mode=mode)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            again = _svc(pkg, disk_path=d)
            hit = again.submit(_q(pkg, *CELLS[0]))
            redo = _wave(pkg, again, CELLS[1:2])[0]
        out[pkg] = (hit.result(0), redo,
                    again.metrics.snapshot()["store_corrupt_evictions"])
        assert hit.result(0).path == "hit"
        assert np.array_equal(_bits(hit.result(0)), _bits(base[0]))
        assert redo.path in ("cold", "near")
        assert abs(redo.r_star - base[1].r_star) <= KW["r_tol"]
        again.close()
    for a, b in zip(out["torch"][:2], out["jax"][:2]):
        assert_matches_jax(a, b)
    assert out["torch"][2] == out["jax"][2] == 1


def test_jax_written_store_serves_no_exact_hit_and_loses_no_file(tmp_path):
    """A store directory the JAX package wrote: its entries are well
    formed, so the port keeps every file, but its keys (no package
    token) never answer an exact hit; an entry donates a warm seed that
    the port's solve verifies."""
    d = str(tmp_path / "store")
    jsvc = _svc("jax", disk_path=d)
    jres = _wave("jax", jsvc, CELLS[1:2])[0]
    jsvc.close()
    files = sorted(os.listdir(d))
    svc = _svc("torch", disk_path=d)
    res = _wave("torch", svc, CELLS[1:2])[0]
    assert res.path == "near" and res.key != jres.key
    assert abs(res.r_star - jres.r_star) <= KW["r_tol"]
    assert svc.metrics.snapshot()["store_corrupt_evictions"] == 0
    assert set(files) <= set(os.listdir(d))
    assert len(os.listdir(d)) == len(files) + 1
    svc.close()
    # the port's own entry is an exact hit in a reopened port service
    again = _svc("torch", disk_path=d)
    hit = again.submit(_q("torch", *CELLS[1])).result(0)
    assert hit.path == "hit" and hit.values == res.values
    again.close()


def test_query_keys_fold_the_package_token():
    t, j = _q("torch", 3.0, 0.6), _q("jax", 3.0, 0.6)
    assert t.group() == j.group()                 # donors are shared
    assert t.key() != j.key()                     # exact hits are not
    assert t.dtype == j.dtype == np.dtype(np.float64)
    assert tserve.make_query(3.0, 0.6, **KW).dtype == np.float32
    with pytest.raises(ValueError, match="float32 or float64"):
        tserve.make_query(3.0, 0.6, dtype=np.float16)


def test_deadline_expired_at_the_seam_fails_typed_as_jax():
    out = {}
    for pkg in ("jax", "torch"):
        mod = PKG[pkg][0]
        clock = FakeClock()
        svc = _svc(pkg, clock=clock)
        fut = svc.submit(_q(pkg, *CELLS[0]), deadline=0.5)
        clock.t = 1.0
        assert svc.flush() == 1
        with pytest.raises(mod.DeadlineExceeded) as ei:
            fut.result(0)
        with pytest.raises(mod.DeadlineExceeded):
            svc.submit(_q(pkg, *CELLS[0]), deadline=0.0)
        out[pkg] = (ei.value.status, ei.value.waited_s,
                    svc.metrics.snapshot()["serve_deadline_expirations"],
                    svc.store.known())
        svc.close()
    assert out["torch"] == out["jax"] == (5, 1.0, 1, 0)


# -- what is not ported, and the device default ------------------------------------

def test_mesh_and_state_shards_raise_naming_item_6():
    with pytest.raises(NotImplementedError, match="item 6"):
        tserve.EquilibriumService(start_worker=False, mesh="auto",
                                  device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        tserve.EquilibriumService(start_worker=False, state_shards=2,
                                  device="cpu")


def test_service_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tserve.EquilibriumService(start_worker=False)
    svc = tserve.EquilibriumService(start_worker=False, device="cpu")
    assert svc._device == torch.device("cpu")
    svc.close()


def test_worker_thread_launches_on_the_constructing_threads_card(monkeypatch):
    """``device=None`` pins the card current where the service is built:
    a worker thread whose own current card differs still launches there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    svc = tserve.EquilibriumService(start_worker=False)
    assert svc._device == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    seen = []
    th = threading.Thread(target=lambda: seen.append(svc._device_scope()))
    th.start()
    th.join(10)
    assert isinstance(seen[0], torch.cuda.device) and seen[0].idx == 1
    explicit = tserve.EquilibriumService(start_worker=False,
                                         device="cuda:0")
    assert explicit._device == torch.device("cuda", 0)
    svc.close()
    explicit.close()
