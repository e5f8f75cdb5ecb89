"""The plain reference against the port on the CPU at a tiny width: at
tight tolerances the two solve the same discretised economy, and the
port's default float64 answers sit inside the cell's limits."""

import json

import numpy as np
import torch

from conftest import ROOT, TINY
from portbench import reference

CFG = {**json.loads((ROOT / "portbench/configs/aiyagari1994_table2.json")
                    .read_text()), **TINY}
CELLS = np.array([[1.5, 0.2, 0.2], [2.5, 0.5, 0.2]])


def _port(**tols):
    from aiyagari_hark_tpu_torch.parallel.sweep import run_sweep

    kw = {k: CFG[k] for k in CFG["port_kwargs"]}
    res = run_sweep(CFG["scenario"], cells=CELLS, dtype=torch.float64,
                    device="cpu", **kw, **tols)
    assert list(res.status) == [0, 0]
    return res.col("r_star"), res.col("capital")


def test_reference_solves_the_ports_economy():
    r, K = _port(r_tol=1e-13, egm_tol=1e-12, dist_tol=1e-15)
    got, diag = reference.evaluate(CELLS, r, K, CFG, "cpu")
    assert max(got["r_gap_bp"]) < 1e-6           # basis points
    assert max(got["capital_rel"]) < 1e-8
    assert diag["egm_diff"] <= reference.EGM_TOL
    assert diag["dist_residual"] < 1e-14


def test_default_answers_within_limits():
    limits = json.loads((ROOT / "portbench/workloads/table2_c24_f64.json")
                        .read_text())["check"]["limits"]
    r, K = _port()
    got = reference.judge(CELLS, r, K, CFG, "cpu")
    assert set(got) == set(limits)
    assert max(got["r_gap_bp"]) <= limits["r_gap_bp"]
    assert max(got["capital_rel"]) <= limits["capital_rel"]


def test_reference_pieces():
    lv, P = reference.tauchen(7, 0.6, 0.2, 3.0)
    assert torch.allclose(P.sum(1), torch.ones(7, dtype=torch.float64))
    assert abs(float(lv.mean()) - 1.0) < 1e-15
    pi = reference.stationary_labor(P)
    assert torch.allclose(pi @ P, pi, atol=1e-15)
    g = reference.exp_mult_grid(0.001, 50.0, 32, 2)
    assert abs(float(g[0]) - 0.001) < 1e-15
    assert abs(float(g[-1]) - 50.0) < 1e-12
    assert bool((g[1:] > g[:-1]).all())


def test_a_moved_root_is_seen():
    r, K = _port()
    got = reference.judge(CELLS, r + 1e-4, K, CFG, "cpu")
    assert min(got["r_gap_bp"]) > 0.5            # 1 bp off, within the Newton step
