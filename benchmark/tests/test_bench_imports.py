"""What the benchmark may import, and what it refuses to run without."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "optimalcontrolmps_tpu"}


def _sources(sub: str = ""):
    top = os.path.join(harness.HERE, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not _imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "optimalcontrolmps_torch" not in _imports(path), path


def test_top_level_names_are_compared_whole():
    sys.modules["jaxlib_lookalike"] = sys
    try:
        found = harness.forbidden_modules()
    finally:
        del sys.modules["jaxlib_lookalike"]
    assert "optimalcontrolmps_torch" not in found
    assert "jaxlib_lookalike" not in found


def test_loading_every_cell_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "import json, os\n"
        "b = harness.load_json(os.path.join(harness.ROOT, 'BENCHMARK.json'))\n"
        "for w in b['workloads']:\n"
        "    s = harness.cell_spec(w['name'], b)\n"
        "    harness.load_module('units', s['unit'])\n"
        "    for m in s['end_to_end'] + s['per_layer']:\n"
        "        harness.load_module('metrics', m['name'])\n"
        "print(json.dumps(harness.forbidden_modules()))\n" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _run(cwd: str):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "bh_L5.multistart",
         "--seed", str((1 << 31) + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def test_without_a_card_the_run_fails_and_prints_no_result():
    out = _run(harness.ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_the_run_fails_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    out = _run(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
