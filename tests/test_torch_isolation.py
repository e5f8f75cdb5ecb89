"""The port runs without JAX: no file of ``aiyagari_hark_tpu_torch/``, not
``chip_smoke.py`` and not ``reproduce_torch.py`` imports ``jax`` or
anything of the JAX package
``aiyagari_hark_tpu`` (a module whose name merely starts with the same
letters, such as the port itself, is not the JAX package)."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "aiyagari_hark_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "aiyagari_hark_tpu")


def _files():
    out = [os.path.join(ROOT, "chip_smoke.py"),
           os.path.join(ROOT, "reproduce_torch.py")]
    for dirpath, _, names in os.walk(PORT):
        out += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_the_scan_sees_the_whole_port():
    rel = {os.path.relpath(p, ROOT) for p in _files()}
    assert "chip_smoke.py" in rel and "reproduce_torch.py" in rel
    assert os.path.join("aiyagari_hark_tpu_torch", "ops", "kernels.py") in rel
    for module in (("models", "portfolio.py"), ("utils", "debug.py"),
                   ("utils", "resilience.py"), ("verify", "inject.py"),
                   ("obs", "runtime.py"), ("obs", "profile.py")):
        assert os.path.join("aiyagari_hark_tpu_torch", *module) in rel
    assert len(rel) >= 15


def test_the_rule_is_not_fooled_by_the_suffix():
    assert _forbidden("aiyagari_hark_tpu.models.household")
    assert _forbidden("aiyagari_hark_tpu")
    assert _forbidden("jax.numpy")
    assert not _forbidden("aiyagari_hark_tpu_torch.models.household")
    assert not _forbidden("jaxtyping_like_name_is_not_jax".replace("_", ""))


@pytest.mark.parametrize("path", _files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
