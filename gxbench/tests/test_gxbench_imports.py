"""The import guard: nothing under ``gxbench/`` imports JAX, flax or the
JAX package (top-level names compared whole, so the port,
``geomx_tpu_torch``, passes), and the reference imports nothing of the
program or of the repo's other scripts.  A run that finds such a module
loaded once the window has closed fails (``harness.forbidden_modules``),
and so does a run without a card or without the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from gxbench import harness
from gxbench.cell import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "geomx_tpu"}
NOT_IN_REFERENCE = {"geomx_tpu_torch", "chip_smoke", "bench", "tools"}


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def _modules(root):
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        yield from (os.path.join(dirpath, f) for f in files
                    if f.endswith(".py"))


def test_no_module_under_gxbench_imports_jax_or_the_jax_package():
    paths = list(_modules(HERE))
    assert len(paths) > 20
    for path in paths:
        bad = set(_imports(path)) & FORBIDDEN
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in _modules(os.path.join(HERE, "reference")):
        bad = set(_imports(path)) & (NOT_IN_REFERENCE | FORBIDDEN)
        assert not bad, (path, bad)


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "geomx_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    monkeypatch.setitem(sys.modules, "geomx_tpu.fake", sys)
    found = harness.forbidden_modules()
    assert "jaxlib.fake" in found and "geomx_tpu.fake" in found
    assert "geomx_tpu_torch_fake" not in found


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "gxbench/run.py", "--workload",
         "resnet20.hips_bsc.b1024", "--seed", str(2 ** 40 + 3),
         "--seconds", "1", "--trace", "0"], cwd=cwd, capture_output=True,
        text=True, timeout=300, env=env)


def test_a_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    done = _run(ROOT, env)
    assert done.returncode != 0
    assert "{" not in done.stdout


def test_a_run_without_the_program_prints_no_result(tmp_path):
    import shutil
    shutil.copytree(HERE, tmp_path / "gxbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    done = _run(tmp_path)
    assert done.returncode != 0
    assert "{" not in done.stdout
