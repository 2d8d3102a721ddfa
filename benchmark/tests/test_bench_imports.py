"""Nothing the benchmark loads is JAX or the JAX package, by whole top-level
name, and the reference loads nothing of the system."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

from benchmark import harness

REFERENCE_SIDE = ("reference.py", "roofline.py", os.path.join("scenes",
                                                               "cornell.py"),
                  os.path.join("scenes", "box_field.py"))


def _imports(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax_or_the_jax_package():
    files = glob.glob(os.path.join(harness.HERE, "**", "*.py"),
                      recursive=True)
    assert files
    for path in files:
        assert not _imports(path) & set(harness.FORBIDDEN), path


def test_reference_side_imports_nothing_of_the_system():
    for rel in REFERENCE_SIDE:
        names = _imports(os.path.join(harness.HERE, rel))
        assert harness.PROGRAM not in names, rel
        assert names <= {"__future__", "math", "dataclasses", "numpy",
                         "torch", "benchmark", "importlib"}, (rel, names)


def _run(code: str) -> str:
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": harness.ROOT},
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout.strip().splitlines()[-1]


def test_reference_loads_nothing_of_the_system():
    got = _run(
        "import sys\n"
        "from benchmark import reference, scenes\n"
        "raw = scenes.build({'kind': 'cornell', **__import__('json').load("
        "open('benchmark/configs/cornell.json'))['scene']})\n"
        "reference.build_scene(raw, 'cpu')\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'pathtracerpython_tpu_torch', 'pathtracerpython_tpu', 'jax'}))\n")
    assert got == "[]"


def test_no_forbidden_module_after_a_cells_setup():
    got = _run(
        "import sys\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from conftest import tiny_cell\n"
        "from benchmark import harness\n"
        "wl, cfg, tr = tiny_cell('cornell.render', size=8, image_spp=16)\n"
        "run = harness.driver(tr['driver']).Run(wl, cfg, tr, 3, 'cpu')\n"
        "run.setup()\n"
        "print(harness.loaded_forbidden(), "
        "'pathtracerpython_tpu_torch' in sys.modules)\n")
    assert got == "[] True"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    fake = {"jaxonomy": None, "pathtracerpython_tpu_torch.ops": None}
    monkeypatch.setattr(sys, "modules", {**sys.modules, **fake})
    assert harness.loaded_forbidden() == []
    monkeypatch.setattr(sys, "modules", {**sys.modules,
                                         "jax.numpy": None,
                                         "pathtracerpython_tpu.kernels": None})
    assert harness.loaded_forbidden() == ["jax", "pathtracerpython_tpu"]
