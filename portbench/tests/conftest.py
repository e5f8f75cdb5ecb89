"""Fixtures of the benchmark's own tests: a copy of the benchmark's data
with the Table II cell cut to a size a CPU test can run.  Run on the CPU:
``python -m pytest portbench/tests -q``."""

import json
import shutil
from pathlib import Path

import sys

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
TINY = {"labor_states": 3, "a_count": 12, "dist_count": 60}


def copy_bench(dst: Path) -> Path:
    """BENCHMARK.json and the benchmark's data files (configs,
    workloads, metric readers) under ``dst``."""
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for sub in ("configs", "workloads", "metrics"):
        shutil.copytree(ROOT / "portbench" / sub, dst / "portbench" / sub)
    return dst


@pytest.fixture
def tiny_bench(tmp_path):
    """A copy whose ``table2_c24_f64`` cell runs 3-cell sweeps at N=3,
    A=12, D=60 over a box whose cells converge at that size, with no
    warm-up, every answer checked, and the cell's own limits."""
    from portbench.harness import Bench

    copy_bench(tmp_path)
    cfg_path = tmp_path / "portbench/configs/aiyagari1994_table2.json"
    cfg = json.loads(cfg_path.read_text())
    cfg.update(TINY)
    cfg_path.write_text(json.dumps(cfg))
    mix_path = tmp_path / "portbench/workloads/table2_c24_f64.json"
    mix = json.loads(mix_path.read_text())
    mix.update(cells_per_sweep=3, warmup_sweeps=0,
               box={"crra": [1.0, 3.0], "rho": [0.0, 0.6], "sd": [0.2, 0.2]})
    mix["check"]["cells"] = 3
    mix_path.write_text(json.dumps(mix))
    return Bench(tmp_path)
