"""The repo's static lints over the PyTorch port.

Each ``scripts/check_*.py`` scans the JAX package and its entry points
(``bench.py``, ``reproduce.py``).  Here each script is loaded as it is
(``importlib``, not edited) and its scope is mapped onto the port: the
package ``aiyagari_hark_tpu`` becomes ``aiyagari_hark_tpu_torch`` in
every scanned root, directory, blessed or allowed file, and the entry
points become ``chip_smoke.py`` and ``reproduce_torch.py``.  So the port
is held to the same rules, with the same blessings (its own
``utils/checkpoint.py`` is the blessed writer and loader, as JAX's is)
and its waivers exactly where the JAX package carries them.
"""

import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "aiyagari_hark_tpu", "aiyagari_hark_tpu_torch"
ENTRY_POINTS = {"bench.py": "chip_smoke.py",
                "reproduce.py": "reproduce_torch.py"}
LINTS = ("check_atomic_writes", "check_integrity_boundaries",
         "check_grid_discipline", "check_obs_events", "check_row_schema",
         "check_timing_discipline", "check_mesh_discipline")
# the module attributes that define a script's scope
SCOPE_ATTRS = ("SCAN_ROOTS", "SCAN_FILES", "SCAN_DIRS", "HOT_DIRS",
               "BLESSED", "ALLOWED_FILES", "ALLOWED_DIRS", "EXEMPT")


def _to_port(value):
    """A scope value (a path, or a tuple/set of paths) on the port."""
    if isinstance(value, str):
        if value == JAX_PKG or value.startswith(JAX_PKG + os.sep):
            return PORT_PKG + value[len(JAX_PKG):]
        return ENTRY_POINTS.get(value, value)
    return type(value)(_to_port(v) for v in value)


def _load(name: str, port: bool = True):
    spec = importlib.util.spec_from_file_location(
        f"{name}_port" if port else name,
        os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if port:
        for attr in SCOPE_ATTRS:
            if hasattr(mod, attr):
                setattr(mod, attr, _to_port(getattr(mod, attr)))
    return mod


@pytest.mark.parametrize("name", LINTS)
def test_lint_is_clean_on_the_port(name):
    mod = _load(name)
    findings = mod.scan(ROOT)
    assert findings == [], "\n".join(
        f"{rel}:{line}: {msg}" for rel, line, msg in findings)


@pytest.mark.parametrize("name", LINTS)
def test_the_mapped_scope_covers_only_the_port(name):
    """Every file the mapped lint walks is the port's or one of its entry
    points, and the walk is not empty."""
    targets = [os.path.relpath(t, ROOT) for t in _load(name).scan_targets(
        ROOT)]
    assert targets
    for rel in targets:
        assert (rel.startswith(PORT_PKG + os.sep)
                or rel in ENTRY_POINTS.values()), rel


def test_the_obs_lint_sees_every_journaled_seam():
    rels = {os.path.relpath(t, ROOT).replace(os.sep, "/")
            for t in _load("check_obs_events").scan_targets(ROOT)}
    for module in ("utils/resilience.py", "utils/fingerprint.py",
                   "utils/checkpoint.py", "parallel/sweep.py",
                   "models/ks_solver.py", "facade.py",
                   "verify/certificate.py", "obs/runtime.py",
                   "obs/profile.py", "obs/regress.py"):
        assert f"{PORT_PKG}/{module}" in rels, module
    assert {"chip_smoke.py", "reproduce_torch.py"} <= rels


def test_the_port_blesses_only_its_own_checkpoint_module():
    for name in ("check_atomic_writes", "check_integrity_boundaries"):
        assert _load(name).BLESSED == {
            os.path.join(PORT_PKG, "utils", "checkpoint.py")}


@pytest.mark.parametrize("src,count", [
    # a typed error raised with no journal event in its function
    ("def f():\n    raise IntegrityError('x')\n", 1),
    ("def f():\n    emit_event('INTEGRITY_FAILED')\n"
     "    raise IntegrityError('x')\n", 0),
    # a seam function that journals nothing
    ("def retry_transient(fn):\n    return fn()\n", 1),
])
def test_the_obs_lint_fires_on_the_port_patterns(src, count):
    """The mapped obs lint still fires: the patterns the port's seams
    avoid are findings."""
    assert len(_load("check_obs_events").scan_source(src, "x.py")) == count


def test_the_jax_scope_is_untouched_by_the_mapping():
    """Mapping a loaded copy leaves the script's own module (and so the
    JAX package's lint tests) on the JAX package."""
    _load("check_obs_events")
    plain = _load("check_obs_events", port=False)
    assert plain.SCAN_ROOTS == (JAX_PKG,)
    assert plain.SCAN_FILES == ("bench.py", "reproduce.py")
