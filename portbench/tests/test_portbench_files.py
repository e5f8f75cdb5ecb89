"""The benchmark finds its files by name: every configuration, traffic
mix and metric reader that BENCHMARK.json names is there and parses, and
a cell added as data files runs with no code edited."""

import json

import numpy as np

from conftest import ROOT, copy_bench
from portbench import traffic
from portbench.harness import Bench, Run, Sweep

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_named_files_parse():
    bench = Bench()
    for c in SPEC["configs"]:
        cfg = bench.config(c["name"])
        assert cfg["source"] == c["source"]
        assert set(cfg["reduced"]) == set(c["reduced"])
        for key in cfg["port_kwargs"]:
            assert isinstance(cfg[key], (int, float))
        assert callable(bench.reference(cfg).judge)
    for w in SPEC["workloads"]:
        mix = bench.traffic(w["traffic"])
        cells = traffic.sweep_cells(mix, 1, 0)
        assert cells.shape == (mix["cells_per_sweep"], 3)
        assert set(mix["check"]["limits"]) == {"r_gap_bp", "capital_rel"}
        e2e = [m["name"] for m in bench.metrics(w["name"], False)]
        layer = [m["name"] for m in bench.metrics(w["name"], True)]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(bench.reader(m["name"]))


def test_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    layer_of = {}
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    bounds = {e["name"]: e["bound"] for e in SPEC["end_to_end"]}
    assert bounds["setup_s"] <= 0.25
    assert all(0.01 <= b <= 0.25 for b in bounds.values())


def test_added_cell_is_found(tmp_path):
    root = copy_bench(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    mix = json.loads((root / "portbench/workloads/table2_c24_f64.json")
                     .read_text())
    mix["cells_per_sweep"] = 7
    (root / "portbench/workloads/extra_mix.json").write_text(
        json.dumps(mix))
    spec["workloads"].append({"name": "extra_cell",
                              "config": "aiyagari1994_table2",
                              "traffic": "extra_mix", "chips": 1,
                              "why": "a cell added as data"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = Bench(root)
    assert bench.traffic(bench.workload("extra_cell")["traffic"])[
        "cells_per_sweep"] == 7
    assert bench.config("aiyagari1994_table2")["labor_states"] == 7
    # a metric without a workloads list is read in every cell
    assert "equilibria_per_s" in [
        m["name"] for m in bench.metrics("extra_cell", False)]


def test_same_seed_same_cells():
    mix = Bench().traffic("table2_c24_f64")
    seed = 2 ** 31 + 977
    a = traffic.sweep_cells(mix, seed, 3)
    assert np.array_equal(a, traffic.sweep_cells(mix, seed, 3))
    assert not np.array_equal(a, traffic.sweep_cells(mix, seed, 4))
    warm = traffic.sweep_cells(mix, seed, 3, traffic.STREAM_WARMUP)
    assert not np.array_equal(a, warm)
    assert np.array_equal(traffic.check_sample(100, 8, seed, must=42),
                          traffic.check_sample(100, 8, seed, must=42))
    assert 42 in traffic.check_sample(100, 8, seed, must=42)


def _sorted(rows):
    return rows[np.lexsort(rows.T)]


def test_every_seed_the_same_cells_in_another_order():
    mix = Bench().traffic("fine_c4_f64")
    a = traffic.sweep_cells(mix, 11, 0)
    b = traffic.sweep_cells(mix, 2 ** 31 + 12, 0)
    assert not np.array_equal(a, b)
    for k in (0, 1, 500):
        assert np.array_equal(_sorted(traffic.sweep_cells(mix, 11, k)),
                              _sorted(traffic.sweep_cells(mix, 12, k)))


def test_no_sweep_repeats_another():
    mix = Bench().traffic("table2_c24_f64")
    rows = np.concatenate([traffic.sweep_cells(mix, 5, k)
                           for k in range(400)])
    assert len(np.unique(rows, axis=0)) == len(rows)


def test_latin_hypercube_strata():
    mix = Bench().traffic("table2_c24_f64")
    for cells in [traffic.sweep_cells(mix, 5, k) for k in range(16)] + [
            traffic.sweep_cells(mix, 5, 0, traffic.STREAM_WARMUP)]:
        C = len(cells)
        for j, axis in enumerate(traffic.AXES):
            lo, hi = mix["box"][axis]
            if hi > lo:
                strata = np.floor((cells[:, j] - lo) / (hi - lo) * C)
                assert sorted(strata) == list(range(C))
            else:
                assert np.all(cells[:, j] == lo)


class _Rows:
    """A stand-in for the engine's result with the columns a reader
    takes."""

    def __init__(self, bisect, egm, dist, status):
        self.wall_seconds = 0.5
        self.cells = np.zeros((len(bisect), 3))
        self.status = np.asarray(status)
        self._cols = {"r_star": np.zeros(len(bisect)),
                      "capital": np.ones(len(bisect)),
                      "bisect_iters": bisect, "egm_iters": egm,
                      "dist_iters": dist}

    def col(self, name):
        return np.asarray(self._cols[name], dtype=float)

    def icol(self, name):
        return np.asarray(self._cols[name], dtype=np.int64)

    def failed_cells(self):
        return np.nonzero(self.status >= 2)[0]


def test_readers_on_counts():
    bench = Bench()
    cfg = bench.config("aiyagari1994_table2")
    sweeps = [Sweep(0.6, _Rows([31, 30], [100, 200], [1000, 3000], [0, 0])),
              Sweep(0.8, _Rows([32, 31], [300, 400], [5000, 7000], [0, 3]))]
    run = Run(sweeps, 2.0, 9.5, cfg, "float64", None)
    read = {m["name"]: bench.reader(m["name"])(run)
            for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    assert read["equilibria_per_s"] == 3 / 2.0
    assert read["setup_s"] == 9.5
    assert abs(read["sweep_p90_s"] - 0.78) < 1e-12
    assert abs(read["engine_ms_per_sweep"] - 200.0) < 1e-9
    assert read["trips_per_cell"] == 31.0
    assert read["dist_steps_per_cell"] == 4000.0
    assert read["egm_steps_per_cell"] == 250.0
    assert run.trips == 31 + 32
    assert 0 < read["mfu_pct"] < 100
    # the trace's readers have nothing to read without a trace
    for name in ("host_ms_per_trip", "kernel_ms_per_trip",
                 "device_idle_pct", "kernels_roofline"):
        assert read[name] is None
