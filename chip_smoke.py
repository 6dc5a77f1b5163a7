"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written Hopper kernels of optimalcontrolmps_torch from
csrc/, holds each against its plain PyTorch twin at the flagship shapes
(B=4096, n=128, N_t=201), then runs the flagship multistart solve
(`flagship.solve_flagship`) on the card and checks its result. Exits non-zero
without a CUDA device or on any failed check; never falls back to the CPU.
Env: SMOKE_BATCH (default 4096) sets the solve's batch.

Output: the card's name and power limit, the build, one line per kernel
check, one JSON line with the solve's result, one {"kernels": [...]} JSON
line, and last {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_SOURCE = "optimalcontrolmps_torch/csrc/sector_chain.cu"
FWD_TOL = 2e-5          # tests/test_pallas_sector.py:51
BWD_TOL = 3e-5          # times max(max|du|, 1), tests/test_pallas_sector.py:75


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` runs, by CUDA events, after
    one warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script needs a GPU")

    from optimalcontrolmps_torch import flagship
    from optimalcontrolmps_torch.ops import _build
    from optimalcontrolmps_torch.ops import sector_chain as sc
    from optimalcontrolmps_torch.precision import enforce_matmul_precision
    from optimalcontrolmps_torch.seeds import adiabatic_seed

    enforce_matmul_precision()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}")

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_sector_chain()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{_build.build_log.get('seconds', 0.0):.2f} s) "
          f"{_build.build_log.get('cmd', 'cached library')}")
    for line in _build.build_log.get("ptxas", "").splitlines():
        if "registers" in line or "Compiling" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # -- kernels against their twins at the flagship shapes ------------------
    dev = torch.device("cuda")
    prob = flagship.make_problem(dev)
    st = prob.st
    Wr, Wi, nn1, h0r, h0i = sc.chain_constants(st, prob.psi_i)
    B, n_t = 4096, int(round(flagship.T / flagship.DT)) + 1
    rng = np.random.default_rng(0)
    u_np = (adiabatic_seed(2.5, 50.0, n_t)[None]
            + rng.normal(0.0, 0.3, (B, n_t))).astype(np.float32)
    u = torch.as_tensor(u_np, device=dev)
    dt = st.dt

    hT_k = sc.chain_fwd(dt, Wr, Wi, nn1, u, h0r, h0i)
    hT_p = sc.chain_final_scan(dt, Wr, Wi, nn1, u, h0r, h0i)
    torch.cuda.synchronize()
    fwd_err = max(float(torch.max(torch.abs(a - b)))
                  for a, b in zip(hT_k, hT_p))
    gTr, gTi = (torch.as_tensor(rng.normal(size=(B, 128)).astype(np.float32),
                                device=dev) for _ in range(2))
    du_k = sc.chain_bwd(dt, Wr, Wi, nn1, u, *hT_p, gTr, gTi)
    du_p = sc.scan_bwd(dt, Wr, Wi, nn1, u, *hT_p, gTr, gTi)
    torch.cuda.synchronize()
    bwd_err = float(torch.max(torch.abs(du_k - du_p)))
    bwd_scale = max(float(torch.max(torch.abs(du_p))), 1.0)

    fwd_ms = cuda_ms(lambda: sc.chain_fwd(dt, Wr, Wi, nn1, u, h0r, h0i), 20)
    fwd_plain_ms = cuda_ms(
        lambda: sc.chain_final_scan(dt, Wr, Wi, nn1, u, h0r, h0i), 5)
    bwd_ms = cuda_ms(
        lambda: sc.chain_bwd(dt, Wr, Wi, nn1, u, *hT_p, gTr, gTi), 20)
    bwd_plain_ms = cuda_ms(
        lambda: sc.scan_bwd(dt, Wr, Wi, nn1, u, *hT_p, gTr, gTi), 5)
    print(f"fwd kernel vs twin (B={B}, N_t={n_t}): max|dh| = {fwd_err:.3e} "
          f"(limit {FWD_TOL:.0e}); kernel {fwd_ms:.4f} ms, "
          f"twin {fwd_plain_ms:.4f} ms")
    print(f"bwd kernel vs twin (B={B}, N_t={n_t}): max|ddu| = {bwd_err:.3e} "
          f"(limit {BWD_TOL:.0e} x {bwd_scale:.3e}); kernel {bwd_ms:.4f} ms, "
          f"twin {bwd_plain_ms:.4f} ms")
    if not fwd_err <= FWD_TOL:
        fail(f"fwd kernel disagrees with its twin: {fwd_err}")
    if not bwd_err <= BWD_TOL * bwd_scale:
        fail(f"bwd kernel disagrees with its twin: {bwd_err}")

    # -- the main path -----------------------------------------------------
    batch = int(os.environ.get("SMOKE_BATCH", "4096"))
    sc.reset_counts()
    out = flagship.solve_flagship(B=batch, device=dev)
    launches = {"fwd": sc.fwd_launches, "bwd": sc.bwd_launches}
    out["solves_per_s"] = batch / out["chip_phase_s"]
    out["launches"] = launches
    out["device"] = kind
    out["power"] = smi
    print(json.dumps(out))

    if not (launches["fwd"] > 0 and launches["bwd"] > 0):
        fail(f"the solve did not run both kernels: {launches}")
    if not (out["all_costs_finite"] and np.isfinite(out["best_cost_f64"])):
        fail("non-finite costs")
    if not (out["converged"] and out["grad_norm_f64"] < 1e-8):
        fail(f"polish did not converge: |g| = {out['grad_norm_f64']}")
    if not (out["best_cost_f64"] < 6e-3 and out["best_infidelity"] < 6e-3):
        fail(f"J* = {out['best_cost_f64']}, "
             f"infidelity = {out['best_infidelity']}")

    print(json.dumps({"kernels": [
        {"name": "sector_chain_fwd", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "optimalcontrolmps_tpu/ops/pallas_sector.py:133",
         "launches": launches["fwd"], "max_abs_err": fwd_err,
         "ms": fwd_ms, "plain_ms": fwd_plain_ms},
        {"name": "sector_chain_bwd", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": "optimalcontrolmps_tpu/ops/pallas_sector.py:159",
         "launches": launches["bwd"], "max_abs_err": bwd_err,
         "ms": bwd_ms, "plain_ms": bwd_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
