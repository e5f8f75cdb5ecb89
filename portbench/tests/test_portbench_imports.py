"""What the benchmark's process loads: never JAX or the JAX package
(top-level names compared whole: the port's name starts with the JAX
package's), and the reference nothing of the port; no file of the
benchmark reads the JAX package's bench files."""

import json
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "aiyagari_hark_tpu"}


def _top_level(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps("
         "sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_port_load_no_jax():
    loaded = _top_level(
        "import sys; sys.path.insert(0, '.')\n"
        "import portbench.harness, portbench.calibrate\n"
        "import aiyagari_hark_tpu_torch.parallel.sweep\n"
        "import aiyagari_hark_tpu_torch.ops.kernels")
    assert "aiyagari_hark_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level("import sys; sys.path.insert(0, '.')\n"
                        "import portbench.reference, portbench.workmodel\n"
                        "import portbench.traffic")
    assert not loaded & (FORBIDDEN | {"aiyagari_hark_tpu_torch"})


def test_no_file_reads_the_jax_bench():
    for f in (ROOT / "portbench").rglob("*.py"):
        if f.parent.name == "tests":
            continue
        text = f.read_text()
        assert "bench.py" not in text and "BENCH_" not in text, f
