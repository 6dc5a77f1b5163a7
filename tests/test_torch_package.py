"""The port stands alone: no module of optimalcontrolmps_torch, not
chip_smoke.py, and none of the port's tools (the `tools/*.py` that import
the port or chip_smoke.py) imports JAX or the JAX package, at the top of a
file or inside a function."""

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
PORT = {"optimalcontrolmps_torch", "chip_smoke"}


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse((ROOT / path).read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


TOOLS = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "tools").glob(
    "*.py") if _imported_roots(p.relative_to(ROOT)) & PORT)


@pytest.mark.parametrize("path", FILES + TOOLS)
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
    "optimalcontrolmps_torch/vidal.py",
    "optimalcontrolmps_torch/dmrg.py",
    "optimalcontrolmps_torch/observables.py",
    "optimalcontrolmps_torch/profiling.py",
    "optimalcontrolmps_torch/drivers/prep_states.py",
    "optimalcontrolmps_torch/drivers/extend_time_evolution.py",
    "optimalcontrolmps_torch/drivers/calculate_defects.py",
    "optimalcontrolmps_torch/drivers/test_runtimes.py",
    "optimalcontrolmps_torch/drivers/analyze_quench.py",
    "optimalcontrolmps_torch/drivers/analyze_bond_dim.py",
    "optimalcontrolmps_torch/parallel/comm.py",
    "optimalcontrolmps_torch/parallel/mesh.py",
    "optimalcontrolmps_torch/parallel/multistart.py",
    "optimalcontrolmps_torch/parallel/dryrun.py",
    "optimalcontrolmps_torch/parallel/spawn.py",
    "optimalcontrolmps_torch/drivers/scaling_bench.py",
    "optimalcontrolmps_torch/native.py",
])
def test_the_slice_modules_are_checked(module):
    """The interior point, Nelder-Mead, the streaming Hessian, the AmoebaOpt
    driver, the Vidal engine, DMRG, the observables, profiling, the
    analysis drivers, the multi-device layer and the host library's
    bindings are among the files checked above."""
    assert module in FILES


def test_the_rank_helper_imports_no_jax():
    """The spawned ranks of tests/test_torch_parallel.py import
    tests/torch_parallel_world.py, which imports the port only."""
    roots = _imported_roots("tests/torch_parallel_world.py")
    assert "optimalcontrolmps_torch" in roots
    assert not roots & FORBIDDEN


def _nccl_rank(rank, world):
    import torch
    import torch.distributed as dist

    from optimalcontrolmps_torch.parallel import comm
    from optimalcontrolmps_torch.parallel.mesh import make_mesh
    m = make_mesh()
    x = torch.tensor([2.0, 1.0, 1.0], device=m.device)
    return {"backend": dist.get_backend(), "device": str(m.device),
            "gathered": comm.all_gather_cat(x, m.group).cpu().tolist(),
            "argmin": comm.argmin_global(x, m.group).index}


@pytest.mark.cuda
def test_native_build_and_a_one_rank_nccl_world():
    """On the card: the host library builds with g++ and loads, and a
    world of one NCCL rank on cuda:0 runs the collectives on the card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from optimalcontrolmps_torch import native
    from optimalcontrolmps_torch.parallel.spawn import run_world
    assert native.sector_count(10, 4, 10) == 72403
    (out,) = run_world(_nccl_rank, 1, backend="nccl", device=None)
    assert out == {"backend": "nccl", "device": "cuda:0",
                   "gathered": [2.0, 1.0, 1.0], "argmin": 1}


@pytest.mark.parametrize("tool", [
    "tools/probe_mps_step.py", "tools/probe_ip_hessian.py",
    "tools/compare_bond_theta.py", "tools/probe_vidal_dmrg.py",
    "tools/probe_analysis.py", "tools/compare_sector_chain.py"])
def test_the_port_tools_are_checked(tool):
    """The port's probes are found among the tools and checked above (the
    JAX package's own probes import JAX and are not the port's)."""
    assert tool in TOOLS


def test_entry_points_print_usage_without_arguments(capsys):
    from optimalcontrolmps_torch.drivers import (amoeba_opt,
                                                 extend_time_evolution,
                                                 optimize_ramp, prep_states)
    for mod in (optimize_ramp, amoeba_opt, extend_time_evolution):
        assert mod.main([]) == 0
        assert "Usage" in capsys.readouterr().out
    assert prep_states.main([]) == 2
    assert "prep_states" in capsys.readouterr().out


def test_helpers_take_the_card_for_none(monkeypatch):
    """device=None means the card for every constructor and entry point,
    the host-array helpers and the flagship's included: without CUDA they
    raise instead of building on the CPU."""
    import numpy as np
    import torch

    from optimalcontrolmps_torch import control, flagship, sector
    from optimalcontrolmps_torch.drivers import (analyze_bond_dim,
                                                 analyze_quench,
                                                 calculate_defects,
                                                 prep_states, test_runtimes)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    z = np.zeros(3)
    for call in (lambda: control.basis_from_numpy(z, z, np.zeros((3, 2))),
                 lambda: sector.stepper_from_numpy({}),
                 lambda: flagship.make_problem(),
                 lambda: flagship.solve_flagship(2),
                 lambda: prep_states.compute(3, 2, 3, 1.0, 2.5, 50.0, 3),
                 lambda: test_runtimes.run(),
                 lambda: calculate_defects.run(),
                 lambda: analyze_quench.run(),
                 lambda: analyze_bond_dim.run()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
