"""The port stands alone: no module of optimalcontrolmps_torch, and not
chip_smoke.py, imports JAX or the JAX package, at the top of a file or
inside a function."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted(str(p.relative_to(ROOT)) for p in
               (ROOT / "optimalcontrolmps_torch").rglob("*.py"))
FILES.append("chip_smoke.py")
FORBIDDEN = {"jax", "jaxlib", "optimalcontrolmps_tpu"}


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse((ROOT / path).read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES)
def test_no_jax_import(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_importing_every_module_loads_no_jax():
    mods = [f[:-3].replace("/", ".").removesuffix(".__init__")
            for f in FILES if f.startswith("optimalcontrolmps_torch/")]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules\n"
            f"             if m.split('.')[0] in {sorted(FORBIDDEN)!r})\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


@pytest.mark.parametrize("module", [
    "optimalcontrolmps_torch/optimize/interior_point.py",
    "optimalcontrolmps_torch/optimize/nelder_mead.py",
    "optimalcontrolmps_torch/streaming.py",
    "optimalcontrolmps_torch/drivers/amoeba_opt.py",
])
def test_the_slice_modules_are_checked(module):
    """The interior point, Nelder-Mead, the streaming Hessian and the
    AmoebaOpt driver are among the files checked above."""
    assert module in FILES


def test_entry_points_print_usage_without_arguments(capsys):
    from optimalcontrolmps_torch.drivers import amoeba_opt, optimize_ramp
    for mod in (optimize_ramp, amoeba_opt):
        assert mod.main([]) == 0
        assert "Usage" in capsys.readouterr().out
