"""The port's scheduler sidecar on the CPU in float64: the measured work
model and same-cell warm seeds (the counterparts of
``tests/test_sweep_scheduler.py``'s sidecar tests and
``tests/test_verify.py``'s sidecar checksum tests), and its layout shared
with the JAX package.

Size: the JAX tests' ``KW``.  Held: the sidecar round-trips and refuses a
foreign fingerprint or a corrupted content; a JAX-written sidecar loads
in the port with every array equal, and the port's ``work_fingerprint``
is JAX's; a sweep writes its sidecar and a rerun predicts exactly the
measured work; the warm, sidecar-seeded balanced sweep keeps the locked
r*, status and NaN masks bitwise (capital to 1e-6) at no more than 0.80
of the locked inner work, in fewer trips; a corrupted sidecar warns and
the sweep runs on its heuristic.
"""

import os
import shutil
import warnings

import numpy as np
import pytest
import torch

import aiyagari_hark_tpu.utils.checkpoint as jck
import aiyagari_hark_tpu.utils.fingerprint as jfp
import aiyagari_hark_tpu_torch.parallel.sweep as tsw
import aiyagari_hark_tpu_torch.utils.fingerprint as tfp
from aiyagari_hark_tpu_torch.utils.checkpoint import (CheckpointMismatchError,
                                                      SweepSidecar,
                                                      load_sweep_sidecar,
                                                      save_sweep_sidecar)
from aiyagari_hark_tpu_torch.utils.config import SweepConfig
from aiyagari_hark_tpu_torch.verify.inject import _rewrite_npz_leaf

torch.set_num_threads(1)
F64 = torch.float64
KW = dict(a_count=12, dist_count=48, labor_states=4, r_tol=1e-5,
          max_bisect=30)
TWO_PANEL = SweepConfig(crra_values=(1.0, 5.0), rho_values=(0.0, 0.9),
                        labor_sd=(0.2, 0.4))
FAULT = {"cell": 2, "at_iter": 2, "mode": "stall"}


def run(sweep, **kw):
    return tsw.run_table2_sweep(sweep, dtype=F64, device="cpu", **kw, **KW)


def test_sidecar_roundtrip_and_fingerprint(tmp_path):
    path = str(tmp_path / "side.npz")
    cells = np.asarray([[1.0, 0.3, 0.2], [5.0, 0.9, 0.4]])
    save_sweep_sidecar(path, cells, [0.041, np.nan], [14, 30], [500, 900],
                       [4000, 9000], [0, 2], fingerprint=123)
    side = load_sweep_sidecar(path, 123)
    assert side.lookup((5.0, 0.9, 0.4)) == 1
    assert side.lookup((1.0, 0.3, 0.2)) == 0
    assert side.lookup((2.0, 0.3, 0.2)) is None
    assert side.total_work().tolist() == [4500, 9900]
    assert np.isnan(side.r_star[1])
    with pytest.raises(CheckpointMismatchError, match="fingerprint"):
        load_sweep_sidecar(path, 999)


def test_sidecar_checksum_roundtrip_and_corruption(tmp_path):
    path = str(tmp_path / "side.npz")
    save_sweep_sidecar(path, [[3.0, 0.6, 0.2]], [0.035], [11], [500],
                       [4000], [0], fingerprint=99)
    side = load_sweep_sidecar(path, 99)
    assert int(side.checksum) == side.content_checksum()
    _rewrite_npz_leaf(path, SweepSidecar._fields.index("r_star"),
                      lambda r: r + 1e-9)
    with pytest.raises(tfp.IntegrityError):
        load_sweep_sidecar(path, 99)


def test_jax_written_sidecar_loads_in_port(tmp_path):
    """Either package's sidecar is the other's: JAX writes, the port
    loads every array bitwise (and the reverse), keyed alike."""
    items = tfp.hashable_kwargs(dict(KW))
    fp = tfp.work_fingerprint(items, F64)
    assert fp == jfp.work_fingerprint(items, np.float64)
    cells = np.asarray(TWO_PANEL.cells())
    rng = np.random.default_rng(0)
    counters = [rng.integers(1, 9000, len(cells)) for _ in range(3)]
    r_star = rng.uniform(0.01, 0.04, len(cells))
    r_star[2] = np.nan
    status = np.where(np.isnan(r_star), 2, 0)
    path = str(tmp_path / "jax_side.npz")
    jck.save_sweep_sidecar(path, cells, r_star, *counters, status, fp,
                           descent_steps=counters[2] // 3,
                           polish_steps=counters[1])
    side = load_sweep_sidecar(path, fp)
    ref = jck.load_sweep_sidecar(path, fp)
    for name, a, b in zip(SweepSidecar._fields, side, ref):
        assert np.array_equal(np.asarray(a), np.asarray(b),
                              equal_nan=True), name
    assert np.array_equal(side.total_work(), ref.total_work())
    back = str(tmp_path / "port_side.npz")
    save_sweep_sidecar(back, cells, r_star, *counters, status, fp)
    assert int(jck.load_sweep_sidecar(back, fp).checksum) == int(
        load_sweep_sidecar(back, fp).checksum)


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """The locked run writes the sidecar; then the fully scheduled run:
    work-sorted buckets and warm brackets (the sidecar's roots for the
    cells the locked run certified, neighbour seeds for the stalled cell
    whose root is NaN), the same injected fault."""
    side = str(tmp_path_factory.mktemp("sched") / "side.npz")
    cfg = TWO_PANEL.replace(sidecar_path=side)
    locked = run(cfg.replace(schedule="locked"), inject_fault=FAULT,
                 max_retries=0)
    assert os.path.exists(side)
    warm = run(cfg.replace(schedule="balanced", n_buckets=2,
                           warm_brackets=True), inject_fault=FAULT,
               max_retries=0)
    return locked, warm


def test_sidecar_seeded_sweep_bit_identical(sweeps):
    locked, warm = sweeps
    assert warm.bucket is not None and locked.bucket is None
    nan_locked = np.isnan(locked.r_star_pct)
    nan_warm = np.isnan(warm.r_star_pct)
    assert (nan_locked == nan_warm).all() and nan_locked[FAULT["cell"]]
    assert np.array_equal(warm.r_star_pct[~nan_warm],
                          locked.r_star_pct[~nan_locked])
    assert np.array_equal(warm.status, locked.status)
    assert np.array_equal(np.isnan(warm.capital), np.isnan(locked.capital))
    np.testing.assert_allclose(warm.capital[~nan_warm],
                               locked.capital[~nan_locked], rtol=1e-6)


def test_sidecar_seeded_sweep_cuts_work(sweeps):
    locked, warm = sweeps
    ok = ~np.isnan(locked.r_star_pct)
    lw = float(locked.total_work()[ok].sum())
    ww = float(warm.total_work()[ok].sum())
    assert ww <= 0.80 * lw, (ww, lw)
    assert (warm.bisect_iters[ok] < locked.bisect_iters[ok]).all()
    # the sidecar's measured work ranked the cells
    assert np.array_equal(warm.predicted_work[ok].astype(np.int64),
                          locked.total_work()[ok])


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    side = str(tmp_path_factory.mktemp("side") / "side.npz")
    cfg = SweepConfig(crra_values=(1.0, 5.0), rho_values=(0.0, 0.9),
                      schedule="balanced", n_buckets=2, sidecar_path=side)
    first = run(cfg)
    assert os.path.exists(side)
    return cfg, first, side


def test_sidecar_written_and_reused(written):
    cfg, first, side = written
    again = run(cfg.replace(work_model="sidecar"))
    assert np.array_equal(np.asarray(again.predicted_work, dtype=np.int64),
                          first.total_work())
    assert np.array_equal(again.r_star_pct, first.r_star_pct)


def test_corrupt_sidecar_degrades_sweep_to_heuristic(written, tmp_path):
    cfg, first, side = written
    bad = str(tmp_path / "side.npz")
    shutil.copy(side, bad)
    _rewrite_npz_leaf(bad, SweepSidecar._fields.index("dist_iters"),
                      lambda it: it + 1)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        again = run(cfg.replace(sidecar_path=bad, work_model="sidecar"))
    msgs = [str(x.message) for x in w]
    assert any("integrity" in m.lower() for m in msgs), msgs
    assert any("using the heuristic" in m for m in msgs), msgs
    np.testing.assert_array_equal(first.r_star_pct, again.r_star_pct)
    assert np.array_equal(again.predicted_work,
                          tsw.heuristic_cell_work(np.asarray(cfg.cells())))
