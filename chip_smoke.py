"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written Hopper kernels of optimalcontrolmps_torch from csrc/
(one nvcc per source, started together) and then, on the card:

1. holds each kernel against its plain PyTorch twin at the shapes its main
   path gives it: the sector chain (fwd, bwd) at B=SMOKE_BATCH, N_t=201;
   the bond theta at BOND_SHAPES (the main path's (LANES, chi=25, p=5)
   complex128 first, up to chi=200 in complex128 and p=10) and on the
   `unbind` views of an MPS batch, with its per-call time (CUDA events) and
   device time per launch (torch.profiler) beside the twin, the einsum
   yardstick and the bound;
2. checks the MPS engine's CostTests golden (L=5, d=5, chi=40, T=0.1, the
   linear ramp 2 -> 50: cost 0.375995 to 1e-5);
3. runs `engine.cost_and_gradient` on the shipped T=2.0 problem on the
   card and on the CPU in complex128 and compares them: at c=0 and at a
   random c with the eigh split, and at c=0 with the svd split;
4. drives the sector main path, `flagship.solve_flagship`;
5. drives the MPS main path, `drivers.optimize_ramp.run`, on
   examples/InputFile_BHcontrolT2.0 with engine = mps, multistart =
   LANES and maxIter = MPS_MAX_ITER (only those keys change);
6. drives the interior point (`useBFGS = no`, the reference driver's
   default): `ip_sector`, the shipped InputFile as shipped but for useBFGS,
   against the JAX package's result (f, iterations, infidelity);
   `ip_flagship_cold`, the flagship GROUP NLP solved cold by
   `minimize_interior_point` with the adaptive barrier; `ip_mps`, the
   shipped config on the MPS engine at T = MPS_IP_T for MPS_IP_MAX_ITER
   iterations in the chunked jit mode and in `ipMode = host` (streaming
   Hessian, hessianRowBlock = ROW_BLOCK), then a `resume = yes` run from
   the jit run's checkpoint;
7. drives `drivers.amoeba_opt.run` (Nelder-Mead) on the shipped config for
   AMOEBA_MAX_ITER iterations;
8. `vidal_exact`: the Vidal engine on the shipped config (chi = 25, no
   truncation): its cost and gradient against the MPS engine's on the
   card, the bond theta on its stages' stacked inputs, the step's time,
   then optimize_ramp.run with engine = vidal, ipMode = host at ip_mps's
   cut, against ip_mps's host run after one iteration;
9. `dmrg_exact`: dmrg_ground_state at L=5 against exact diagonalization;
10. `vidal_scaled`: optimize_ramp.run on SCALED_CONFIG, the JAX package's
   reference-scale run (N=20, d=7, chi=128, complex64), cut to one
   host-mode iteration at T = SCALED_T: both boundary states by DMRG on the
   card, gated on their sweep energies and particle number; then the bond
   theta on its stages' inputs, the step's time and the SVD's share of a
   DMRG sweep;
11. the analysis drivers, each through its run() entry: `analysis_chain`
   at the reference drivers' widths (N=20, Npart=20, d=7, tstep 5e-3,
   complex64, cut to T = ANALYSIS_T and maxM ANALYSIS_MAXM: ANALYSIS_CUTS):
   prep_states at chi 64 (DMRG), analyze_quench, calculate_defects
   (maxBondDim 70, engine = vidal) and analyze_bond_dim with the gradient,
   one state cache for all, gated on the physics and on the prep state's
   observables, with the bond theta at the path's stage shapes;
   `analysis_shipped`: extend_time_evolution on ip_sector's converged
   ramp on the Vidal and the sector engine (equal to 1e-8), and
   test_runtimes with the Hessian; `analysis_card_vs_cpu`: three drivers
   at the shipped widths on the card and on the CPU in complex128;
12. the multi-device layer (`parallel/`): `parallel_1rank`, a world of one
   NCCL rank on cuda:0, runs the sector multistart at the flagship's
   widths (B = PAR_BATCH, exact gradient through the fused chain) sharded
   against unsharded, the MPS train step with the row-sharded Hessian at
   the shipped widths (T = PAR_TRAIN_T) against engine.hessian, the
   tensor-parallel Vidal rollout at N=20, d=7, chi=128 from
   analysis_chain's prep state against vidal.rollout_final, the bond theta
   at TP_THETA_SHAPES, the dry run and scaling_bench; `parallel_2rank`,
   two spawned gloo ranks both computing on cuda:0 (the only real
   cross-rank sharding one card allows), runs the same against the
   one-rank phase's references, plus a full PAR_SOLVE_ITERS solve; their
   kernels are built here before the spawn, and each rank's launches are
   added here; `native`: the host library (g++) against its Python twin.

Each main path is driven with every launch counter set to 0 just before it
and read just after; the `kernels` line sums each kernel's launches over
the paths. Exits non-zero without a CUDA device or on any failed
check; never falls back to the CPU. Env: SMOKE_BATCH (default 4096) sets the
sector solve's batch.

Output: the card's name and power limit, the build, one line per check and
phase (with its wall time), one JSON line per main path, one
{"kernels": [...]} JSON line, and last {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SECTOR_SOURCE = "optimalcontrolmps_torch/csrc/sector_chain.cu"
BOND_SOURCE = "optimalcontrolmps_torch/csrc/bond_theta.cu"
EXAMPLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "examples", "InputFile_BHcontrolT2.0")
FWD_TOL = 2e-5          # tests/test_pallas_sector.py:51
BWD_TOL = 3e-5          # times max(max|du|, 1), tests/test_pallas_sector.py:75
# max|kernel - twin| / max|twin|: tests/test_pallas_kernels.py:22 for
# complex64; complex128 sums the same products in another order
THETA_TOL = {torch.complex64: 1e-5, torch.complex128: 1e-12}
GOLDEN, GOLDEN_TOL = 0.375995, 1e-5     # tests/test_cost_golden.py:66
# card vs CPU in complex128: |dJ| absolute, max|dg| / max|g|. The split by
# eigh of the density matrix resolves Schmidt values only down to
# sqrt(eps) ~ 1.5e-8 of the largest, and cuSOLVER and LAPACK resolve the
# smallest ones (and the padded null space, a gauge) differently, so the
# states differ at that level after 2 x 200 steps; the cost is quadratic in
# them and agrees far better. The svd split resolves them to eps, so its
# reading is the witness for that cause. A real fault (the backward gate
# read unconjugated) showed as 0.7.
CARD_CPU_COST_TOL = 1e-12
CARD_CPU_GRAD_TOL = 1e-8
MPS_MAX_ITER = 1        # L-BFGS iterations of the MPS driver's lanes
LANES = 4               # the MPS driver's multistart lanes
NPART = 5
# the JAX package on the CPU in float64, through its optimize_ramp.run on
# the shipped InputFile with useBFGS = no, seed 1 (25 + 14 iterations in
# two ipChunks), and its minimize_interior_point on the flagship GROUP NLP
# from c = 0 with the adaptive barrier
# (tests/test_streaming_hessian.py::test_flagship_group_cold_ip_converges_1e8)
IP_SECTOR_F, IP_SECTOR_ITERS = 0.010181131084581343, 39
IP_SECTOR_INFIDELITY = 8.632337886542496e-3
IP_COLD_F, IP_COLD_ITERS = 0.004942845820563654, 15
IP_F_TOL, IP_ITER_TOL, IP_INFIDELITY_TOL = 1e-9, 2, 1e-8
MPS_IP_T, MPS_IP_MAX_ITER, ROW_BLOCK = 0.5, 3, 16
# f after one step, host mode (streaming Hessian, rows stepped in blocks)
# against the chunked jit mode (dense Hessian, rows in one batch): the same
# arithmetic, bitwise equal on the CPU (tests/test_torch_driver.py holds the
# two modes to 1e-10 there). On the card a row stepped in another batch
# comes out ~1e-9 apart, at the eigh split's ~sqrt(eps) resolution, and H
# ~1e-5 of its scale apart (tools/probe_ip_hessian.py), so one Newton step
# later the costs read ~3e-9 apart.
HOST_JIT_REL_TOL = 1e-8
AMOEBA_MAX_ITER = 200
# a multistart lane's coefficients: numpy seed 0, sigma 0.5
C_RAND = np.random.default_rng(0).normal(0.0, 0.5, 10)
# the Vidal engine against the MPS engine without truncation (chi = 25 is
# the exact rank bound of L=5, d=4): cost and gradient to 1e-8
# (tests/test_vidal.py:102-110); f after one interior-point step to 1e-6
# relative, the level at which the two engines' Hessians agree
# (tests/test_vidal.py:229-241)
VIDAL_MPS_TOL, VIDAL_IP_REL_TOL = 1e-8, 1e-6
# DMRG against the exact sector ground state (tests/test_dmrg.py:23-27)
DMRG_E_TOL, DMRG_OVERLAP_TOL = 1e-9, 1e-8
# the JAX package's only reference-scale run, cut to fit: its keys as
# shipped but truncMethod (the port has eigh, not the TPU's nssub), T (N_t
# = 11 of its 301), maxIter and stateCache (the run makes both boundary
# states by DMRG); SCALED_N is the chain's length (the config's N = 20)
SCALED_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "artifacts", "baseline3",
                             "InputFile_BHcontrolT6.0")
SCALED_T, SCALED_N = 0.2, 20
# the reference scale's gates: DMRG sweep energies may rise by 1e-6 |E|
# (DMRG searches in complex128, then hands over complex64 states), the
# particle number of the states and of ExpectationN.txt (complex64) is held
# to 1e-4
SCALED_E_RISE, SCALED_NPART_TOL = 1e-6, 1e-4
IP_FILES = ("BHrampInitialFinal.txt", "ExpectationN.txt", "GRAPEHessian.txt",
            "GROUPHessian.txt", "ProgressCache.txt", "checkpoint.json")
# the analysis drivers at the reference drivers' own widths (AnalyzeQuench,
# CalculateDefects, AnalyzeBondDim: N=20, Npart=20, d=7, tstep 5e-3), in
# complex64 on the card. ANALYSIS_CUTS lists every cut of scale.
ANALYSIS_N, ANALYSIS_D, ANALYSIS_TSTEP = 20, 7, 5e-3
ANALYSIS_T = 0.1                    # N_t = 21
ANALYSIS_CHI_PREP, ANALYSIS_MAXM = 64, 128
ANALYSIS_BOND_DIMS = (20, 30, 40, 50, ANALYSIS_MAXM)
ANALYSIS_CUTS = {
    "T": "3.0 (analyze_quench) / 5.0 (calculate_defects, analyze_bond_dim)"
         " -> 0.1: N_t 601 / 1001 -> 21, the smoke's time limit",
    "maxM": "1000 -> 128 in analyze_quench and analyze_bond_dim: chi = 128 "
            "is the repo's reference scale (artifacts/baseline3); at 1000 "
            "the theta is 8000^2 per bond",
}
# the stage shapes the analysis gives the bond theta: the even (10) and odd
# (9) bonds of one lane at each chi, p = 8, complex64 (chi = 128 is checked
# on the analysis state's own stage inputs)
ANALYSIS_STAGE_CHIS = (20, 30, 40, 50, 70)
# physics gates of the long chain (complex64): particle number, entropies,
# fidelities, the prep state's single-particle density matrix, and the
# shared-environment correlators against the pairwise ones
ANALYSIS_NPART_TOL, ANALYSIS_S_FLOOR, ANALYSIS_F_CEIL = 1e-4, -1e-6, 1e-5
ANALYSIS_HERM_TOL, ANALYSIS_TRACE_TOL, ANALYSIS_WINDOW_TOL = 1e-5, 1e-4, 1e-5
ANALYSIS_WINDOW = (6, 12)   # analyze_quench's default sites (0-based)
# the analysis drivers on the card against the CPU in complex128 (the
# shipped widths, L=5, d=4, T=0.1): values to 1e-8, the gradient to 1e-8
# relative, the bound CARD_CPU_GRAD_TOL of the eigh-split gradients above
ANALYSIS_CARD_CPU_TOL = 1e-8
ANALYSIS_CARD_CPU_BOND_DIMS = (10, 25)
# extend_time_evolution on the Vidal engine against the sector engine, both
# exact at the shipped widths (chi = 25), complex128
EXTEND_VIDAL_SECTOR_TOL = 1e-8
# test_runtimes at T = RUNTIMES_T: the same cost at every batch size
# (complex64 on the card)
RUNTIMES_T, RUNTIMES_COST_REL_TOL = 0.2, 1e-5
# the multi-device phases. The sector multistart at the flagship's widths
# and seeds (B = PAR_BATCH, bench.py:205-207), exact gradient through the
# fused chain: lane by lane against the unsharded call after
# PAR_CHECK_ITERS iterations (one rank: bitwise; two ranks: float32 lanes in
# another batch, ROADMAP "Float32 lockstep L-BFGS"), then a full solve of
# PAR_SOLVE_ITERS on two ranks. The MPS train step at the shipped widths
# (chi = 25, complex128), T cut to PAR_TRAIN_T (the dense Hessian's cost),
# PAR_TRAIN_B lanes: its Hessian diagonal against engine.hessian to 1e-8
# relative (a row stepped in another batch moves an entry ~1e-9 relative on
# the card, tools/probe_ip_hessian.py). The tensor-parallel Vidal rollout
# at the reference scale (analysis_chain's prep state padded to chi 128,
# complex64, TP_STEPS steps of ANALYSIS_TSTEP) against vidal.rollout_final:
# |<tp|ref>| / (|tp| |ref|) within TP_OV_TOL of 1 (an MPS contraction; no
# state vector at N = 20) and Schmidt values to TP_SCHMIDT_TOL on one rank
# (TP_SCHMIDT_TOL_SPLIT on two, below).
PAR_BATCH, PAR_CHECK_ITERS, PAR_SOLVE_ITERS, PAR_TOL = 4096, 6, 150, 1e-5
PAR_LANE_REL_TOL = 1e-6
PAR_TRAIN_T, PAR_TRAIN_B, PAR_HESS_REL_TOL = 0.5, 8, 1e-8
TP_STEPS, TP_OV_TOL, TP_SCHMIDT_TOL = 20, 1e-6, 1e-5
# two ranks step each stage's bonds in other batches (5 / 5 and 5 / 4
# instead of 10 / 9), and on the card a complex64 bond update in another
# batch rounds differently: the Schmidt values then move by up to 3.3e-5
# after 20 steps (measured on one H100), the density matrices' eigenvalues being
# resolved only to ~eps32 of the largest (lam = sqrt(w): ~3.5e-4 at the
# tail). So two ranks are held to TP_SCHMIDT_TOL_SPLIT, one rank (the same
# batches) to TP_SCHMIDT_TOL; `parallel_1rank` reads the unsharded rollout
# at twice the batch against itself as the witness of that floor.
TP_SCHMIDT_TOL_SPLIT = 1e-4
# the bond theta's shares of a tensor-parallel stage at N = 20 on two
# ranks: 10 even bonds 5 / 5, 9 odd bonds 5 / 4 (chi 128, p = 8)
TP_THETA_SHAPES = ((5, 128, 8), (4, 128, 8))
# the host library: both sectors enumerated by both routes; the COO of the
# first against the Python twin (indices exact, values to 1e-12)
NATIVE_CASES = ((10, 4, 10), (12, 5, 12))
NATIVE_COO_TOL = 1e-12

# published H100 SXM peaks (NVIDIA data sheet): memory; fp32 on the CUDA
# cores; fp64 through the tensor cores (DMMA), the card's peak for the type
# (34 TFLOP/s on the CUDA cores, which the bond theta uses); dense TF32 on
# the tensor cores, where an fp32-grade product takes TF32_PASSES passes
# (3xTF32: small*big + big*small + big*big), the sector kernels' route
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 67e12}
PEAK_TF32, TF32_PASSES = 495e12, 3


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


def bound(ops: float, nbytes: float, peak: float) -> tuple:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate (FLOP/s) of the route that does them."""
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


class Phases:
    """Wall time of each phase, printed as it ends."""

    def __init__(self):
        self.t = time.perf_counter()

    def done(self, name: str) -> None:
        torch.cuda.synchronize()
        now = time.perf_counter()
        print(f"[phase] {name}: {now - self.t:.2f} s", flush=True)
        self.t = now


def reset_all_counts() -> None:
    from optimalcontrolmps_torch.ops import bond_theta as bt
    from optimalcontrolmps_torch.ops import sector_chain as sc
    sc.reset_counts()
    bt.reset_counts()


def launch_counts() -> dict:
    from optimalcontrolmps_torch.ops import bond_theta as bt
    from optimalcontrolmps_torch.ops import sector_chain as sc
    return {"sector_chain_fwd": sc.fwd_launches,
            "sector_chain_bwd": sc.bwd_launches,
            "bond_theta": bt.bond_theta_launches}


def check_sector_chain(batch: int) -> dict:
    """Both sector-chain kernels against their twins at N_t=201, at batch
    (the flagship's, also timed) and at batch // 2 (a rank's share in
    parallel_2rank, which the kernels tile in 16-row n-tiles, not 32)."""
    from optimalcontrolmps_torch import flagship
    from optimalcontrolmps_torch.ops import sector_chain as sc
    from optimalcontrolmps_torch.seeds import adiabatic_seed

    dev = torch.device("cuda")
    prob = flagship.make_problem(dev)
    st = prob.st
    Wr, Wi, nn1, h0r, h0i = sc.chain_constants(st, prob.psi_i)
    n_t, n = int(round(flagship.T / flagship.DT)) + 1, Wr.shape[0]
    dt = st.dt

    def check(B):
        rng = np.random.default_rng(0)
        u = torch.as_tensor((adiabatic_seed(2.5, 50.0, n_t)[None]
                             + rng.normal(0.0, 0.3, (B, n_t))
                             ).astype(np.float32), device=dev)
        hT_k = sc.chain_fwd(dt, Wr, Wi, nn1, u, h0r, h0i)
        hT_p = sc.chain_final_scan(dt, Wr, Wi, nn1, u, h0r, h0i)
        torch.cuda.synchronize()
        fwd_err = max(float(torch.max(torch.abs(a - b)))
                      for a, b in zip(hT_k, hT_p))
        gT = [torch.as_tensor(rng.normal(size=(B, n)).astype(np.float32),
                              device=dev) for _ in range(2)]
        du_k = sc.chain_bwd(dt, Wr, Wi, nn1, u, *hT_p, *gT)
        du_p = sc.scan_bwd(dt, Wr, Wi, nn1, u, *hT_p, *gT)
        torch.cuda.synchronize()
        bwd_err = float(torch.max(torch.abs(du_k - du_p)))
        bwd_scale = max(float(torch.max(torch.abs(du_p))), 1.0)
        print(f"sector kernels vs twins (B={B}, N_t={n_t}): fwd max|dh| = "
              f"{fwd_err:.3e} (limit {FWD_TOL:.0e}), bwd max|ddu| = "
              f"{bwd_err:.3e} (limit {BWD_TOL:.0e} x {bwd_scale:.3e})")
        if not fwd_err <= FWD_TOL:
            fail(f"sector fwd kernel disagrees with its twin at B={B}: "
                 f"{fwd_err}")
        if not bwd_err <= BWD_TOL * bwd_scale:
            fail(f"sector bwd kernel disagrees with its twin at B={B}: "
                 f"{bwd_err}")
        return u, hT_p, gT, fwd_err, bwd_err

    B = batch
    u, hT_p, gT, fwd_err, bwd_err = check(B)
    _, _, _, half_fwd_err, half_bwd_err = check(B // 2)
    fwd_err, bwd_err = max(fwd_err, half_fwd_err), max(bwd_err, half_bwd_err)

    fwd_ms = cuda_ms(lambda: sc.chain_fwd(dt, Wr, Wi, nn1, u, h0r, h0i), 20)
    fwd_plain_ms = cuda_ms(
        lambda: sc.chain_final_scan(dt, Wr, Wi, nn1, u, h0r, h0i), 5)
    bwd_ms = cuda_ms(lambda: sc.chain_bwd(dt, Wr, Wi, nn1, u, *hT_p, *gT), 20)
    bwd_plain_ms = cuda_ms(
        lambda: sc.scan_bwd(dt, Wr, Wi, nn1, u, *hT_p, *gT), 5)

    # per step and row: four real (ns x ns) products forward; the
    # reversible backward rebuilds h and carries g, eight. ns = 121 states
    # of the padded 128 (W is the identity on the padding). Bytes: inputs
    # once, outputs once, float32. Two routes: the CUDA cores' fp32 rate,
    # and three TF32 passes on the tensor cores (the kernels' route); the
    # bound is the lesser, and both are printed with the share.
    ns, steps, f32 = st.ns, n_t - 1, 4
    work = {
        "fwd": (2 * 4 * ns * ns * steps * B,
                f32 * (2 * ns * ns + 3 * ns + B * n_t + 2 * B * ns), fwd_ms,
                fwd_plain_ms),
        "bwd": (2 * 8 * ns * ns * steps * B,
                f32 * (2 * ns * ns + ns + B * n_t + 4 * B * ns + B * n_t),
                bwd_ms, bwd_plain_ms)}
    bounds = {}
    for name, (ops, nbytes, ms, plain_ms) in work.items():
        cuda_cores = bound(ops, nbytes, PEAK_FLOPS[torch.float32])
        tensor_cores = bound(ops, nbytes, PEAK_TF32 / TF32_PASSES)
        bounds[name] = min(cuda_cores, tensor_cores)
        print(f"sector {name} kernel (B={B}, N_t={n_t}): {ms:.4f} ms, twin "
              f"{plain_ms:.4f} ms; bounds (ns={ns}): CUDA cores "
              f"{cuda_cores[0]:.4f} ms, tensor cores 3xTF32 "
              f"{tensor_cores[0]:.4f} ms; {100 * bounds[name][0] / ms:.1f}% "
              f"of the lesser ({bounds[name][1]})")
    fwd_bound, bwd_bound = bounds["fwd"], bounds["bwd"]
    base = {"route": "cuda", "source": SECTOR_SOURCE, "library_ms": None}
    return {
        "sector_chain_fwd": {
            **base, "name": "sector_chain_fwd",
            "replaces": "optimalcontrolmps_tpu/ops/pallas_sector.py:133",
            "max_abs_err": fwd_err, "ms": fwd_ms, "plain_ms": fwd_plain_ms,
            "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1]},
        "sector_chain_bwd": {
            **base, "name": "sector_chain_bwd",
            "replaces": "optimalcontrolmps_tpu/ops/pallas_sector.py:159",
            "max_abs_err": bwd_err, "ms": bwd_ms, "plain_ms": bwd_plain_ms,
            "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1]},
    }


def kernel_device_ms(fn, reps: int, name: str):
    """Device milliseconds per launch of the kernels whose name holds
    `name`, read with torch.profiler over `reps` calls of fn after one
    warm-up: their self device time over their launches. None when the
    profiler saw no such kernel."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key]
    count = sum(e.count for e in rows)
    if not count:
        return None
    return sum(e.self_device_time_total for e in rows) / 1e3 / count


def theta_inputs(B, chi, p, dtype, seed=0):
    """Ai, Aj (B, chi, p, chi) and G (p^2, p^2) on the card, numpy seed."""
    rng = np.random.default_rng(seed)

    def mk(*s):
        return torch.as_tensor(rng.standard_normal(s)
                               + 1j * rng.standard_normal(s),
                               dtype=dtype, device="cuda")
    return mk(B, chi, p, chi), mk(B, chi, p, chi), mk(p * p, p * p)


def theta_bound(B, chi, p, dtype) -> tuple:
    """(bound_ms, bound_by) of one bond-theta call: 8 (chi^3 p^2 + p^4
    chi^2) real operations per element; Ai, Aj and G read once, theta
    written once."""
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    csize = 16 if dtype == torch.complex128 else 8
    ops = 8 * (chi ** 3 * p ** 2 + p ** 4 * chi ** 2) * B
    nbytes = csize * (B * (2 * chi * chi * p + chi * chi * p * p) + p ** 4)
    return bound(ops, nbytes, PEAK_FLOPS[real])


# (B, chi, p, dtype): the MPS main path's bond (LANES, 25, 5) complex128
# first; a reference-scale bond (chi=128, p=8); the reference's DMRG scale
# (chi=200, d=7) and chi=128 in its default double precision; the largest p;
# and small ragged shapes
# the interior point's MPS Hessians step their row states as one batch: up
# to N_t - 2 rows (49 at T=0.5, 199 at the shipped T=2.0), a streaming row
# block at a time (ROW_BLOCK asked; 10 divides N_t - 1 = 50 at T=0.5)
BOND_SHAPES = ((LANES, 25, 5, torch.complex128),
               (LANES, 25, 5, torch.complex64),
               (ROW_BLOCK, 25, 5, torch.complex128),
               (10, 25, 5, torch.complex128),
               (49, 25, 5, torch.complex128),
               (199, 25, 5, torch.complex128),
               (8, 128, 8, torch.complex64), (1, 200, 8, torch.complex128),
               (2, 128, 8, torch.complex128), (2, 24, 10, torch.complex128),
               (3, 1, 2, torch.complex64), (2, 13, 3, torch.complex64))


def theta_reading(Ai, Aj, G, label: str = "") -> dict:
    """The bond-theta kernel against its twin on the card inputs Ai, Aj
    (B, chi, p, chi) and G: the relative error (fails above THETA_TOL), the
    per-call time by CUDA events over 50 back-to-back calls (`ms`, the
    median of five such readings), the kernel's device time per launch by
    torch.profiler (`device_ms`), the twin, the one-einsum yardstick and
    the bound."""
    from optimalcontrolmps_torch.ops import bond_theta as bt

    B, chi, p, _ = Ai.shape
    dtype = Ai.dtype
    name = str(dtype).split(".")[-1]
    try:
        out = bt.bond_theta(Ai, Aj, G)
    except (RuntimeError, ValueError) as exc:
        fail(f"bond_theta refused (B={B}, chi={chi}, p={p}, {name}): {exc}")
    ref = bt.bond_theta_reference(Ai, Aj, G)
    G4 = G.reshape(p, p, p, p)

    def library():
        return torch.einsum('PQpq,bapc,bcqd->baPQd', G4, Ai, Aj)
    lib = library().reshape(B, chi * p, p * chi)
    torch.cuda.synchronize()
    abs_err = float(torch.max(torch.abs(out - ref)))
    rel = abs_err / float(torch.max(torch.abs(ref)))
    lib_rel = float(torch.max(torch.abs(lib - ref))
                    / torch.max(torch.abs(ref)))
    # the host's enqueue bounds the small shapes' calls and swings within
    # a run: the median of five readings of 50 calls each
    k_ms = sorted(cuda_ms(lambda: bt.bond_theta(Ai, Aj, G), 50)
                  for _ in range(5))[2]
    k_dev = kernel_device_ms(lambda: bt.bond_theta(Ai, Aj, G), 50,
                             "bond_theta_kernel")
    p_ms = cuda_ms(lambda: bt.bond_theta_reference(Ai, Aj, G), 50)
    l_ms = cuda_ms(library, 50)
    b_ms, b_by = theta_bound(B, chi, p, dtype)
    dev_txt = "not measured" if k_dev is None else f"{k_dev:.4f} ms"
    print(f"bond_theta kernel vs twin {label}(B={B}, chi={chi}, p={p}, "
          f"{name}): max|d|/max|ref| = {rel:.3e} (limit "
          f"{THETA_TOL[dtype]:.0e}); per call {k_ms:.4f} ms, device "
          f"{dev_txt}, twin {p_ms:.4f} ms, einsum {l_ms:.4f} ms, bound "
          f"{b_ms:.5f} ms ({b_by})")
    if not rel < THETA_TOL[dtype]:
        fail(f"bond_theta disagrees with its twin at B={B}, chi={chi}, "
             f"p={p}, {dtype}: {rel}")
    if not lib_rel < THETA_TOL[dtype]:
        fail(f"the einsum yardstick computes another function: {lib_rel}")
    return {"B": B, "chi": chi, "p": p, "dtype": name,
            "inputs": label.strip() or "random",
            "max_abs_err": abs_err, "rel_err": rel, "ms": k_ms,
            "device_ms": k_dev, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def check_bond_theta() -> dict:
    """The bond-theta kernel against its twin at BOND_SHAPES (numpy seed 0
    inputs, `theta_reading`) and on the `unbind` views of an MPS batch."""
    from optimalcontrolmps_torch.ops import bond_theta as bt

    checks = [theta_reading(*theta_inputs(B, chi, p, dtype))
              for B, chi, p, dtype in BOND_SHAPES]

    # the TEBD engine's inputs: `unbind` views of a (B, L, chi, p, chi)
    # batch, batch stride L*chi*p*chi, taken without a copy
    B, chi, p, dtype = BOND_SHAPES[0]
    rng = np.random.default_rng(1)
    shape = (B, 5, chi, p, chi)
    A = torch.as_tensor(rng.standard_normal(shape)
                        + 1j * rng.standard_normal(shape), dtype=dtype,
                        device="cuda")
    G = theta_inputs(1, 1, p, dtype)[2]
    sites = A.unbind(1)
    for i in range(4):
        out = bt.bond_theta(sites[i], sites[i + 1], G)
        ref = bt.bond_theta_reference(sites[i].contiguous(),
                                      sites[i + 1].contiguous(), G)
        rel = float(torch.max(torch.abs(out - ref))
                    / torch.max(torch.abs(ref)))
        if not rel < THETA_TOL[dtype]:
            fail(f"bond_theta on unbind views (bond {i}): {rel}")
    print(f"bond_theta on unbind views of {tuple(shape)}: 4 bonds agree "
          f"with the twin on copies (last rel {rel:.3e})")

    main = checks[0]
    return {"bond_theta": {
        "name": "bond_theta", "route": "cuda", "source": BOND_SOURCE,
        "replaces": "optimalcontrolmps_tpu/ops/pallas_kernels.py:30",
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        "ms": main["ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "checks": checks}}


def check_golden() -> float:
    """CostTests physics (tests/test_cost_golden.py) on the card."""
    from optimalcontrolmps_torch import engine, groundstate, seeds, tebd

    dt, T, chi = 0.01, 0.1, 40
    n = int(round(T / dt)) + 1
    st = tebd.make_stepper(5, 5, 1.0, dt, chi, device="cuda")
    psi_i = groundstate.initialize_state(5, 5, 5, 1.0, 2.0, chi,
                                         device="cuda")
    psi_f = groundstate.initialize_state(5, 5, 5, 1.0, 50.0, chi,
                                         device="cuda")
    u = torch.as_tensor(seeds.linspace(2.0, 50.0, n), device="cuda")
    J = float(engine.cost(st, psi_i, psi_f, u, 0.0))
    print(f"MPS golden on the card: cost {J:.12f} (want {GOLDEN} to "
          f"{GOLDEN_TOL:.0e})")
    if not abs(J - GOLDEN) < GOLDEN_TOL:
        fail(f"MPS golden: {J} != {GOLDEN}")
    return J


def example_config(**changes):
    from optimalcontrolmps_torch import config
    cfg = config.parse_input_file(EXAMPLE)
    cfg.values.update({k: str(v) for k, v in changes.items()})
    return cfg


def check_card_vs_cpu() -> tuple:
    """engine.cost_and_gradient on the shipped problem (L=5, d=4, chi=25,
    N_t=201, complex128), on the card and on the CPU: at c=0 and at C_RAND
    (as a multistart lane) with the driver's eigh split, and at c=0 with the
    svd split. Returns (readings, the card's (J, g) by label)."""
    from optimalcontrolmps_torch import engine
    from optimalcontrolmps_torch.drivers import common

    readings, card = {}, {}
    for label, method, c in (("c=0 eigh", "eigh", np.zeros(10)),
                             ("random c eigh", "eigh", C_RAND),
                             ("c=0 svd", "svd", np.zeros(10))):
        cfg = example_config(engine="mps", truncMethod=method)
        res = {}
        for dev in ("cuda", "cpu"):
            p = common.build_problem(cfg, engine="mps", device=dev)
            u = p.basis.convert_control(torch.as_tensor(c, device=dev))
            t0 = time.perf_counter()
            J, g = engine.cost_and_gradient(p.stepper, p.psi_i, p.psi_f, u,
                                            p.gamma)
            res[dev] = (float(J), g.cpu(), time.perf_counter() - t0)
        (Jc, gc, tc), (Jh, gh, th) = res["cuda"], res["cpu"]
        g_rel = float(torch.max(torch.abs(gc - gh))
                      / torch.max(torch.abs(gh)))
        print(f"cost_and_gradient at {label}, card vs CPU (complex128): J "
              f"{Jc:.12f} vs {Jh:.12f} (|dJ| {abs(Jc - Jh):.2e}, limit "
              f"{CARD_CPU_COST_TOL:.0e}), max|dg|/max|g| {g_rel:.2e} (limit "
              f"{CARD_CPU_GRAD_TOL:.0e}); card {tc:.2f} s, CPU {th:.2f} s")
        if not (abs(Jc - Jh) < CARD_CPU_COST_TOL
                and g_rel < CARD_CPU_GRAD_TOL):
            fail(f"card and CPU disagree at {label}: dJ {abs(Jc - Jh)}, "
                 f"dg {g_rel}")
        readings[label] = {"J": Jc, "dJ": abs(Jc - Jh), "g_rel": g_rel,
                           "card_s": tc, "cpu_s": th}
        card[label] = (Jc, gc)
    print(json.dumps({"card_vs_cpu": readings}))
    return readings, card


def drive_sector(batch: int, kind: str, smi: str) -> dict:
    from optimalcontrolmps_torch import flagship
    from optimalcontrolmps_torch.ops import sector_chain as sc

    reset_all_counts()
    out = flagship.solve_flagship(B=batch, device=torch.device("cuda"))
    launches = {"fwd": sc.fwd_launches, "bwd": sc.bwd_launches}
    out["solves_per_s"] = batch / out["chip_phase_s"]
    out["launches"] = launches
    out["device"] = kind
    out["power"] = smi
    print(json.dumps(out))
    if not (launches["fwd"] > 0 and launches["bwd"] > 0):
        fail(f"the sector solve did not run both kernels: {launches}")
    if not (out["all_costs_finite"] and np.isfinite(out["best_cost_f64"])):
        fail("sector solve: non-finite costs")
    if not (out["converged"] and out["grad_norm_f64"] < 1e-8):
        fail(f"polish did not converge: |g| = {out['grad_norm_f64']}")
    if not (out["best_cost_f64"] < 6e-3 and out["best_infidelity"] < 6e-3):
        fail(f"J* = {out['best_cost_f64']}, "
             f"infidelity = {out['best_infidelity']}")
    return launches


def drive_mps(lanes: int) -> int:
    """optimize_ramp.run on the shipped T=2.0 config, engine = mps."""
    from optimalcontrolmps_torch import config, engine
    from optimalcontrolmps_torch.drivers import common, optimize_ramp
    from optimalcontrolmps_torch.ops import bond_theta as bt
    from optimalcontrolmps_torch.optimize.penalty import bound_penalty

    cfg = example_config(engine="mps", multistart=lanes,
                         maxIter=MPS_MAX_ITER)
    # the objective at c=0, which lane 0 starts from
    p = common.build_problem(cfg, engine="mps")
    u0 = p.basis.convert_control(torch.zeros(p.M, dtype=torch.float64,
                                             device=p.device))
    f0 = float(engine.cost(p.stepper, p.psi_i, p.psi_f, u0, p.gamma)
               + bound_penalty(u0))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "InputFile")
        config.write_input_file(path, cfg.values)
        prefix = os.path.join(tmp, "out_")
        reset_all_counts()
        t0 = time.perf_counter()
        out = optimize_ramp.run(path, seed=1, out_prefix=prefix)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = bt.bond_theta_launches
        files = {f: os.path.exists(prefix + f) for f in (
            "BHrampInitialFinal.txt", "ExpectationN.txt",
            "ProgressCache.txt", "checkpoint.json")}
        expn = (np.loadtxt(prefix + "ExpectationN.txt")
                if files["ExpectationN.txt"] else np.zeros((0, 6)))
    costs = out["status"]["batch_costs"]
    npart_err = float(np.abs(expn[:, 1:].sum(axis=1) - NPART).max()) \
        if expn.size else float("inf")
    print(json.dumps({
        "mps_driver": {"lanes": lanes, "max_iter": MPS_MAX_ITER,
                       "cost_c0": f0, "batch_costs": costs,
                       "best": out["status"]["f"],
                       "iterations": out["status"]["iterations"],
                       "n_evals": out["status"]["n_evals"],
                       "infidelity": out["infidelity"],
                       "bond_theta_launches": launches, "files": files,
                       "expectation_rows": int(expn.shape[0]),
                       "npart_max_err": npart_err, "wall_s": wall}}))
    if not launches > 0:
        fail("the MPS driver launched no bond_theta kernel")
    if not all(np.isfinite(costs)):
        fail(f"MPS driver: non-finite lane costs {costs}")
    if not min(costs) < f0:
        fail(f"MPS driver: best cost {min(costs)} not below c=0's {f0}")
    if not all(files.values()):
        fail(f"MPS driver: missing output files {files}")
    if not (expn.shape[0] == p.n_steps and npart_err < 1e-8):
        fail(f"ExpectationN.txt: {expn.shape[0]} rows, particle number off "
             f"by {npart_err}")
    return launches


def run_driver(module, cfg, tmp: str):
    """module.run on the config written under tmp; (result, out prefix,
    wall s)."""
    from optimalcontrolmps_torch import config
    path = os.path.join(tmp, "InputFile")
    config.write_input_file(path, cfg.values)
    prefix = os.path.join(tmp, "out_")
    t0 = time.perf_counter()
    out = module.run(path, seed=1, out_prefix=prefix)
    torch.cuda.synchronize()
    return out, prefix, time.perf_counter() - t0


def npart_error(prefix: str, n_steps: int) -> float:
    """max |sum_i <n_i>(t) - Npart| of ExpectationN.txt (inf if it has
    another number of rows)."""
    expn = np.loadtxt(prefix + "ExpectationN.txt")
    if expn.ndim != 2 or expn.shape[0] != n_steps:
        return float("inf")
    return float(np.abs(expn[:, 1:].sum(axis=1) - NPART).max())


def drive_ip_sector() -> dict:
    """optimize_ramp.run on the shipped InputFile with useBFGS = no (engine
    auto -> sector, double precision, optTol 1e-8, maxIter 500), seed 1.
    The result keeps the converged BHrampInitialFinal.txt (`ramp_text`)."""
    from optimalcontrolmps_torch.drivers import optimize_ramp

    cfg = example_config(useBFGS="no")
    with tempfile.TemporaryDirectory() as tmp:
        reset_all_counts()
        out, prefix, wall = run_driver(optimize_ramp, cfg, tmp)
        files = {f: os.path.exists(prefix + f) for f in IP_FILES}
        n_err = npart_error(prefix, 201)
        with open(prefix + "BHrampInitialFinal.txt") as f:
            ramp_text = f.read()
    st = out["status"]
    res = {"f": st["f"], "iterations": st["iterations"],
           "converged": st["converged"], "kkt": st["kkt_error"],
           "infidelity": out["infidelity"], "files": files,
           "npart_max_err": n_err, "wall_s": wall,
           "launches": launch_counts()}
    print(json.dumps({"ip_sector": res}))
    if not st["converged"]:
        fail(f"ip_sector did not converge: kkt {st['kkt_error']}")
    if not abs(st["f"] - IP_SECTOR_F) <= IP_F_TOL:
        fail(f"ip_sector f = {st['f']!r}, want {IP_SECTOR_F!r}")
    if not abs(st["iterations"] - IP_SECTOR_ITERS) <= IP_ITER_TOL:
        fail(f"ip_sector took {st['iterations']} iterations, want "
             f"{IP_SECTOR_ITERS} +- {IP_ITER_TOL}")
    if not abs(out["infidelity"] - IP_SECTOR_INFIDELITY) <= IP_INFIDELITY_TOL:
        fail(f"ip_sector infidelity {out['infidelity']!r}")
    if not all(files.values()):
        fail(f"ip_sector: missing output files {files}")
    if not n_err < 1e-8:
        fail(f"ip_sector: ExpectationN.txt off Npart by {n_err}")
    # the converged ramp, for the analysis phase's extend_time_evolution
    res["ramp_text"] = ramp_text
    return res


def drive_ip_flagship_cold() -> dict:
    """minimize_interior_point on the flagship GROUP NLP (L=5, Npart=5,
    d=4, T=2.0, M=10, gamma=1e-6, the linsigmoid seed of rng(123456789)),
    cold from c = 0, adaptive barrier, optTol 1e-8, on the card."""
    from optimalcontrolmps_torch import control, sector, seeds
    from optimalcontrolmps_torch.optimize import minimize_interior_point

    dev = torch.device("cuda")
    T, dt, M, L, d, gamma = 2.0, 0.01, 10, 5, 4, 1e-6
    n = int(round(T / dt)) + 1
    st = sector.make_sector_stepper(L, d, NPART, 1.0, dt, device=dev)
    psi_i, psi_f = (sector.sector_ground_state(L, d, NPART, 1.0, u,
                                               device=dev)
                    for u in (2.5, 50.0))
    basis = control.chopped_sine_basis(
        seeds.linsigmoid_seed(2.5, 50.0, n,
                              rng=np.random.default_rng(123456789)),
        dt, T, M, device=dev)

    def cheap(c):
        return sector.cost(st, psi_i, psi_f, basis.convert_control(c), gamma)

    def fg(c):
        g, J = torch.func.grad_and_value(cheap)(c)
        return J, g

    def fgh(c):
        J, g = fg(c)
        return J, g, basis.convert_hessian(sector.hessian(
            st, psi_i, psi_f, basis.convert_control(c), gamma))

    reset_all_counts()
    t0 = time.perf_counter()
    r = minimize_interior_point(
        fgh, torch.zeros(M, dtype=torch.float64, device=dev),
        B=basis.jacobian(), u0=basis.u0, tol=1e-8, max_iter=60, fun=cheap,
        fun_grad=fg, mu_strategy="adaptive")
    torch.cuda.synchronize()
    res = {"f": float(r.f), "iterations": int(r.iterations),
           "converged": bool(r.converged), "kkt": float(r.kkt_error),
           "wall_s": time.perf_counter() - t0, "launches": launch_counts()}
    print(json.dumps({"ip_flagship_cold": res}))
    if not res["converged"]:
        fail(f"ip_flagship_cold did not converge: kkt {res['kkt']}")
    if not abs(res["f"] - IP_COLD_F) <= IP_F_TOL:
        fail(f"ip_flagship_cold f = {res['f']!r}, want {IP_COLD_F!r}")
    if not abs(res["iterations"] - IP_COLD_ITERS) <= IP_ITER_TOL:
        fail(f"ip_flagship_cold took {res['iterations']} iterations")
    return res


def drive_ip_mps() -> dict:
    """optimize_ramp.run on the shipped config with engine = mps,
    useBFGS = no, T = MPS_IP_T, maxIter = MPS_IP_MAX_ITER: in the chunked
    jit mode, in ipMode = host, and resumed from the jit run's checkpoint
    for one iteration."""
    from optimalcontrolmps_torch import engine
    from optimalcontrolmps_torch.drivers import common, optimize_ramp
    from optimalcontrolmps_torch.ops import bond_theta as bt

    base = dict(engine="mps", useBFGS="no", T=MPS_IP_T,
                maxIter=MPS_IP_MAX_ITER)
    p = common.build_problem(example_config(**base), engine="mps")

    def cost_at(c):
        u = p.basis.convert_control(torch.as_tensor(
            c, dtype=torch.float64, device=p.device))
        return float(engine.cost(p.stepper, p.psi_i, p.psi_f, u, p.gamma))

    f0 = cost_at(np.zeros(p.M))
    runs, launches = {}, 0
    with tempfile.TemporaryDirectory() as tmp:
        for mode, extra in (("jit", {"ipMode": "jit"}),
                            ("host", {"ipMode": "host",
                                      "hessianRowBlock": ROW_BLOCK,
                                      "hessianProgress": "no"})):
            os.mkdir(os.path.join(tmp, mode))
            reset_all_counts()
            out, prefix, wall = run_driver(
                optimize_ramp, example_config(**base, **extra),
                os.path.join(tmp, mode))
            with open(prefix + "checkpoint.json") as f:
                ck = json.load(f)
            st = out["status"]
            runs[mode] = {"f": st["f"], "iterations": st["iterations"],
                          "history": st["history"], "wall_s": wall,
                          "bond_theta_launches": bt.bond_theta_launches,
                          "checkpoint_keys": sorted(ck["extra"]),
                          "npart_max_err": npart_error(prefix, p.n_steps)}
            launches += bt.bond_theta_launches
            if mode == "jit":
                ck_jit, prefix_jit = ck, prefix
        # resume from the jit run's checkpoint, one iteration
        rdir = os.path.join(tmp, "resume")
        os.mkdir(rdir)
        with open(os.path.join(rdir, "out_checkpoint.json"), "w") as f:
            json.dump(ck_jit, f)
        reset_all_counts()
        out, prefix, wall = run_driver(
            optimize_ramp, example_config(**{
                **base, "resume": "yes", "maxIter": 1,
                "writeHessians": "no"}), rdir)
        launches += bt.bond_theta_launches
    start = out.get("resumed_from", {})
    x_clip = np.clip(ck_jit["control"], -20.0 + 0.4, 20.0 - 0.4)
    f_start = cost_at(x_clip)
    runs["resume"] = {"f": out["status"]["f"], "wall_s": wall,
                      "first_f": out["status"]["history"][0][1],
                      "cost_at_clipped_checkpoint": f_start}
    f1 = {m: runs[m]["history"][1][1] for m in ("jit", "host")}
    rel = abs(f1["jit"] - f1["host"]) / abs(f1["jit"])
    res = {"cost_c0": f0, "T": MPS_IP_T, "max_iter": MPS_IP_MAX_ITER,
           "row_block": ROW_BLOCK, "f_after_iteration_1": f1,
           "host_jit_rel": rel, "runs": runs}
    print(json.dumps({"ip_mps": res}))
    for mode in ("jit", "host"):
        r = runs[mode]
        if not r["f"] < f0:
            fail(f"ip_mps {mode}: cost {r['f']} not below c=0's {f0}")
        if not r["bond_theta_launches"] > 0:
            fail(f"ip_mps {mode}: no bond_theta launch")
        if not {"duals", "mu"} <= set(r["checkpoint_keys"]):
            fail(f"ip_mps {mode}: final checkpoint lacks duals/mu")
        if not r["npart_max_err"] < 1e-8:
            fail(f"ip_mps {mode}: ExpectationN.txt off by "
                 f"{r['npart_max_err']}")
    if not rel <= HOST_JIT_REL_TOL:
        fail(f"ip_mps: host and jit f after iteration 1 differ by {rel}")
    if not (start.get("x") == ck_jit["control"]
            and start.get("mu") == ck_jit["extra"]["mu"]
            and start.get("duals") == ck_jit["extra"]["duals"]):
        fail("ip_mps: the resumed run did not start from the checkpoint")
    if not abs(runs["resume"]["first_f"] - f_start) <= 1e-12 * f_start:
        fail(f"ip_mps: the resumed run's first f "
             f"{runs['resume']['first_f']} is not the cost at the clipped "
             f"checkpoint, {f_start}")
    res["launches"] = launches
    return res


def drive_amoeba() -> dict:
    """amoeba_opt.run on the shipped config (engine auto -> sector) for
    AMOEBA_MAX_ITER iterations."""
    from optimalcontrolmps_torch import engine
    from optimalcontrolmps_torch.drivers import amoeba_opt, common
    from optimalcontrolmps_torch.optimize.penalty import bound_penalty

    cfg = example_config(maxIter=AMOEBA_MAX_ITER)
    p = common.build_problem(cfg, engine="auto")
    u0 = p.basis.convert_control(torch.zeros(p.M, dtype=torch.float64,
                                             device=p.device))
    from optimalcontrolmps_torch.backends import engine_for
    f0 = float(engine_for(p.stepper).cost(p.stepper, p.psi_i, p.psi_f, u0,
                                          p.gamma) + bound_penalty(u0))
    with tempfile.TemporaryDirectory() as tmp:
        reset_all_counts()
        out, _, wall = run_driver(amoeba_opt, cfg, tmp)
    res = {"engine": p.kind, "cost_c0": f0, "f": out["f"],
           "iterations": out["iterations"], "n_evals": out["n_evals"],
           "wall_s": wall, "launches": launch_counts()}
    print(json.dumps({"amoeba": res}))
    if not out["f"] < f0:
        fail(f"amoeba: f {out['f']} not below c=0's {f0}")
    return res


def vidal_lanes(state, lanes: int):
    """A one-state VidalState repeated into a batch of `lanes`."""
    from optimalcontrolmps_torch import vidal
    return vidal.VidalState(
        state.B[None].repeat(lanes, 1, 1, 1, 1).contiguous(),
        state.lam[None].repeat(lanes, 1, 1).contiguous())


def stage_inputs(S, bonds):
    """The bond-theta inputs of one Vidal stage: the sites of `bonds` of
    every lane, stacked bond-major as vidal._stage stacks them."""
    return (torch.cat([S.B[:, b] for b in bonds]),
            torch.cat([S.B[:, b + 1] for b in bonds]))


def vidal_stage_thetas(st, state, lanes: int, label: str) -> list:
    """The kernel against its twin on both stages' stacked inputs of a
    `lanes` batch of `state` (`theta_reading`)."""
    S = vidal_lanes(state, lanes)
    return [theta_reading(*stage_inputs(S, range(first, st.L - 1, 2)),
                          st.gate_fwd, f"{label} {kind} stage ")
            for first, kind in ((0, "even"), (1, "odd"))]


def vidal_step_reading(st, state, lanes: int, reps: int) -> dict:
    """ms of one vidal_step of a `lanes` batch (CUDA events, mean of reps
    after a warm-up) and the ms of its two stages' batched eighs alone
    (their density matrices rebuilt from the stage inputs): eigh's share."""
    from optimalcontrolmps_torch import vidal
    from optimalcontrolmps_torch.ops.bond_theta import bond_theta
    from optimalcontrolmps_torch.ops.trunc import _jitter

    S = vidal_lanes(state, lanes)
    u = torch.full((lanes,), 10.0, dtype=state.lam.dtype,
                   device=state.B.device)
    step_ms = cuda_ms(lambda: vidal.vidal_step(st, S, u, u), reps)
    eigh_ms = 0.0
    for first in (0, 1):
        th = bond_theta(*stage_inputs(S, range(first, st.L - 1, 2)),
                        st.gate_fwd)
        rho = _jitter(th.conj().transpose(-2, -1) @ th)
        eigh_ms += cuda_ms(lambda: torch.linalg.eigh(rho), reps)
    out = {"lanes": lanes, "L": st.L, "chi": st.chi, "p": st.p,
           "dtype": str(state.B.dtype).split(".")[-1], "step_ms": step_ms,
           "eigh_ms": eigh_ms, "eigh_share": eigh_ms / step_ms}
    print(f"vidal_step (lanes={lanes}, L={st.L}, chi={st.chi}, p={st.p}, "
          f"{out['dtype']}): {step_ms:.3f} ms, of which the two stages' "
          f"eigh {eigh_ms:.3f} ms ({100 * out['eigh_share']:.1f}%)")
    return out


def drive_vidal_exact(mps_card: dict, ip_mps_f1: float) -> dict:
    """The Vidal engine on the shipped problem (L=5, d=4, chi=25 = the exact
    rank bound, complex128): cost and gradient at c=0 and C_RAND against the
    MPS engine's on the card (`mps_card`, from check_card_vs_cpu); the
    bond theta on its stage inputs at one lane and LANES lanes; the step's
    time; then optimize_ramp.run with engine = vidal, useBFGS = no,
    ipMode = host, ip_mps's cut (T = MPS_IP_T, maxIter = MPS_IP_MAX_ITER,
    hessianRowBlock = ROW_BLOCK), its f after one iteration against
    ip_mps's host mode (`ip_mps_f1`)."""
    from optimalcontrolmps_torch import vidal
    from optimalcontrolmps_torch.drivers import common, optimize_ramp
    from optimalcontrolmps_torch.ops import bond_theta as bt

    p = common.build_problem(example_config(engine="vidal"), engine="vidal")
    agree = {}
    for label, c in (("c=0 eigh", np.zeros(10)), ("random c eigh", C_RAND)):
        u = p.basis.convert_control(torch.as_tensor(c, device=p.device))
        t0 = time.perf_counter()
        J, g = vidal.cost_and_gradient(p.stepper, p.psi_i, p.psi_f, u,
                                       p.gamma)
        J = float(J)
        wall = time.perf_counter() - t0
        Jm, gm = mps_card[label]
        dg = float(torch.max(torch.abs(g.cpu() - gm)))
        agree[label] = {"J": J, "dJ": abs(J - Jm), "dg": dg, "s": wall}
        print(f"vidal vs mps engine on the card at {label}: J {J:.12f} "
              f"(|dJ| {abs(J - Jm):.2e}), max|dg| {dg:.2e} (limit "
              f"{VIDAL_MPS_TOL:.0e}); {wall:.2f} s")
        if not (abs(J - Jm) < VIDAL_MPS_TOL and dg < VIDAL_MPS_TOL):
            fail(f"vidal and mps engines disagree at {label}: dJ "
                 f"{abs(J - Jm)}, dg {dg}")
    thetas = (vidal_stage_thetas(p.stepper, p.psi_i, 1, "vidal_exact")
              + vidal_stage_thetas(p.stepper, p.psi_i, LANES, "vidal_exact"))
    steps = [vidal_step_reading(p.stepper, p.psi_i, b, 10)
             for b in (1, LANES)]

    cfg = example_config(engine="vidal", useBFGS="no", T=MPS_IP_T,
                         maxIter=MPS_IP_MAX_ITER, ipMode="host",
                         hessianRowBlock=ROW_BLOCK, hessianProgress="no")
    p = common.build_problem(cfg, engine="vidal")
    f0 = float(vidal.cost(p.stepper, p.psi_i, p.psi_f,
                          p.basis.convert_control(torch.zeros(
                              p.M, dtype=torch.float64, device=p.device)),
                          p.gamma))
    with tempfile.TemporaryDirectory() as tmp:
        reset_all_counts()
        out, prefix, wall = run_driver(optimize_ramp, cfg, tmp)
        launches = bt.bond_theta_launches
        n_err = npart_error(prefix, p.n_steps)
    st = out["status"]
    f1 = st["history"][1][1]
    rel = abs(f1 - ip_mps_f1) / abs(ip_mps_f1)
    res = {"agree": agree, "thetas": thetas, "steps": steps,
           "ip_host": {"f": st["f"], "iterations": st["iterations"],
                       "history": st["history"], "f1_vs_mps_rel": rel,
                       "npart_max_err": n_err, "wall_s": wall,
                       "bond_theta_launches": launches}}
    print(json.dumps({"vidal_exact": res}))
    if not launches > 0:
        fail("vidal_exact: the driver launched no bond_theta kernel")
    if not st["f"] < f0:
        fail(f"vidal_exact: cost {st['f']} not below c=0's {f0}")
    if not rel <= VIDAL_IP_REL_TOL:
        fail(f"vidal_exact: f after iteration 1 {f1} vs ip_mps host "
             f"{ip_mps_f1}: rel {rel}")
    if not n_err < 1e-8:
        fail(f"vidal_exact: ExpectationN.txt off Npart by {n_err}")
    res["launches"] = launches
    return res


def drive_dmrg_exact() -> dict:
    """dmrg_ground_state(5, 4, 5, 1.0, 2.5, chi=25) on the card, complex128,
    against the exact sector ground state: energy and overlap."""
    from optimalcontrolmps_torch import dmrg, groundstate, mps

    L, d, U, chi = 5, 4, 2.5, 25
    t0 = time.perf_counter()
    # device=None: the card, as for every entry point of the port
    A, e, hist = dmrg.dmrg_ground_state(L, d, NPART, 1.0, U, chi=chi,
                                        return_history=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    E0 = float(np.linalg.eigvalsh(groundstate.sector_hamiltonian(
        L, d, NPART, 1.0, U))[0])
    vec = groundstate.ground_statevector(L, d, NPART, 1.0, U)
    ov = abs(np.vdot(mps.to_statevector(A[None])[0].cpu().numpy(), vec))
    res = {"E": e, "E_exact": E0, "dE": abs(e - E0), "overlap": ov,
           "sweeps": len(hist), "history": hist, "wall_s": wall,
           "s_per_sweep": wall / len(hist)}
    print(json.dumps({"dmrg_exact": res}))
    if not abs(e - E0) < DMRG_E_TOL:
        fail(f"dmrg_exact: E = {e!r}, exact {E0!r}")
    if not abs(ov - 1.0) < DMRG_OVERLAP_TOL:
        fail(f"dmrg_exact: |<exact|dmrg>| = {ov!r}")
    return res


class DmrgRecorder:
    """Records every DMRG sweep (chi, seconds, energy) and every ground
    state that `groundstate.initialize_state` makes by DMRG, while in its
    `with` block."""

    def __init__(self):
        self.sweeps, self.states = [], []

    def __enter__(self):
        from optimalcontrolmps_torch import dmrg, groundstate
        self._sweep, self._ground = dmrg._sweep, groundstate.dmrg_ground_state

        def sweep(A, W, chi, krylov):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            A, e = self._sweep(A, W, chi, krylov)
            torch.cuda.synchronize()
            self.sweeps.append((chi, time.perf_counter() - t0, e))
            return A, e

        def ground(*args, **kw):
            t0 = time.perf_counter()
            A, e, hist = self._ground(*args, return_history=True, **kw)
            self.states.append({"A": A, "E": e, "history": hist,
                                "s": time.perf_counter() - t0,
                                "U": args[4]})
            return A, e

        dmrg._sweep, groundstate.dmrg_ground_state = sweep, ground
        return self

    def __exit__(self, *exc):
        from optimalcontrolmps_torch import dmrg, groundstate
        dmrg._sweep, groundstate.dmrg_ground_state = self._sweep, self._ground


def drive_vidal_scaled() -> dict:
    """optimize_ramp.run on SCALED_CONFIG (L = SCALED_N, d=7, maxBondDim
    128 -> chi = 128, complex64, M=30, tstep 0.02, engine = vidal,
    ipMode = host, hessianRowBlock 30) with truncMethod = eigh, T =
    SCALED_T, maxIter = 1, stateCache = no: both boundary states by DMRG
    on the card (the chi ramp 10, 20, 50, 100, 128), one host-mode
    interior-point iteration (segmented gradient, one streaming Hessian)
    and the streaming finalize. Then the bond theta on both stages' stacked
    inputs of the initial state, the step's time, and the SVD's share of a
    DMRG sweep at the top chi (the middle bond's split, timed alone)."""
    from optimalcontrolmps_torch import config, dmrg, mps, tebd, vidal
    from optimalcontrolmps_torch.drivers import optimize_ramp
    from optimalcontrolmps_torch.ops import bond_theta as bt
    from optimalcontrolmps_torch.sites import op

    cfg = config.parse_input_file(SCALED_CONFIG)
    cfg.values.update({"truncMethod": "eigh", "T": str(SCALED_T),
                       "maxIter": "1", "stateCache": "no"})
    if SCALED_N != cfg.get_int("N"):
        # unit filling, as shipped
        cfg.values.update({"N": str(SCALED_N), "Npart": str(SCALED_N)})
    L, d, npart = cfg.get_int("N"), cfg.get_int("d"), cfg.get_int("Npart")
    n_steps = int(SCALED_T / cfg.get_real("tstep") + 1)
    with tempfile.TemporaryDirectory() as tmp, DmrgRecorder() as rec:
        reset_all_counts()
        out, prefix, wall = run_driver(optimize_ramp, cfg, tmp)
        launches = bt.bond_theta_launches
        expn = np.loadtxt(prefix + "ExpectationN.txt")
    n_err = (float(np.abs(expn[:, 1:].sum(axis=1) - npart).max())
             if expn.ndim == 2 and expn.shape[0] == n_steps
             else float("inf"))
    states = []
    for s in rec.states:
        E = [h[1] for h in s["history"]]
        rise = max([b - a for a, b in zip(E, E[1:])] + [0.0])
        ntot = float(mps.expectation_values(
            s["A"][None], op("N", d)).real.sum())
        states.append({"U": s["U"], "E": s["E"], "s": s["s"],
                       "sweeps": len(E), "history": s["history"],
                       "max_rise": rise, "npart_err": abs(ntot - npart)})
    chi = max(c for c, _, _ in rec.sweeps)
    top = [t for c, t, _ in rec.sweeps if c == chi]

    # the kernel and the step at this scale, on the Vidal form of the
    # initial state; the SVD split's share of a sweep at the top chi
    A = rec.states[0]["A"]
    st = tebd.make_stepper(L, d, 1.0, cfg.get_real("tstep"), chi,
                           dtype=A.dtype, sweep="vidal", device=A.device)
    state = vidal.from_mps(A, device=A.device)
    thetas = vidal_stage_thetas(st, state, 1, "vidal_scaled")
    step = vidal_step_reading(st, state, 1, 3)
    # the split of the middle bond's two-site theta, as DMRG makes it (in
    # complex128, dmrg.SVD_DRIVER), against PyTorch's default driver
    p = d + 1
    mid = L // 2 - 1
    m = torch.einsum('lpm,mqr->lpqr', A[mid], A[mid + 1]).to(
        torch.complex128).reshape(1, chi * p, p * chi)
    svd_ms = {drv or "default": cuda_ms(
        lambda: torch.linalg.svd(m, full_matrices=False, driver=drv), 3)
        for drv in (dmrg.SVD_DRIVER, None)}
    svd_share = (2 * (L - 1) * svd_ms[dmrg.SVD_DRIVER] / 1e3
                 / (sum(top) / len(top)))
    st_out = out["status"]
    res = {"L": L, "d": d, "chi": chi, "n_steps": n_steps,
           "f": st_out["f"], "iterations": st_out["iterations"],
           "history": st_out["history"], "infidelity": out["infidelity"],
           "npart_max_err": n_err, "wall_s": wall,
           "dmrg_states": states,
           "dmrg_sweeps": [[c, t] for c, t, _ in rec.sweeps],
           "dmrg_s_per_sweep_top_chi": sum(top) / len(top),
           "svd_ms": svd_ms, "svd_share": svd_share,
           "thetas": thetas, "step": step, "bond_theta_launches": launches}
    print(f"vidal_scaled DMRG: {[round(s['s'], 2) for s in states]} s per "
          f"state, {res['dmrg_s_per_sweep_top_chi']:.3f} s per sweep at "
          f"chi={chi}, the SVD split {100 * svd_share:.1f}% of it "
          f"(svd ms {svd_ms})")
    print(json.dumps({"vidal_scaled": res}))
    if not launches > 0:
        fail("vidal_scaled: the driver launched no bond_theta kernel")
    if len(states) != 2:
        fail(f"vidal_scaled: {len(states)} DMRG states, want 2")
    for s in states:
        if not s["max_rise"] <= SCALED_E_RISE * abs(s["E"]):
            fail(f"vidal_scaled: a DMRG sweep energy rose by "
                 f"{s['max_rise']} (U = {s['U']})")
        if not s["npart_err"] < SCALED_NPART_TOL:
            fail(f"vidal_scaled: DMRG particle number off by "
                 f"{s['npart_err']} (U = {s['U']})")
    if not (np.isfinite(st_out["f"]) and st_out["iterations"] >= 1):
        fail(f"vidal_scaled: f = {st_out['f']}, iterations "
             f"{st_out['iterations']}")
    if not n_err < SCALED_NPART_TOL:
        fail(f"vidal_scaled: ExpectationN.txt off Npart by {n_err}")
    res["launches"] = launches
    return res


def analysis_config(path: str, **keys) -> str:
    """Write an InputFile of the long chain (ANALYSIS_N sites at unit
    filling, d = ANALYSIS_D, tstep ANALYSIS_TSTEP, T = ANALYSIS_T,
    complex64, engine vidal) with `keys` added; returns its path."""
    from optimalcontrolmps_torch import config
    values = {"N": ANALYSIS_N, "Npart": ANALYSIS_N, "d": ANALYSIS_D,
              "tstep": ANALYSIS_TSTEP, "T": ANALYSIS_T, "M": 1,
              "precision": "single", "engine": "vidal", **keys}
    config.write_input_file(path, {k: str(v) for k, v in values.items()})
    return path


def counted(fn, *args, **kw):
    """(fn(*args, **kw), its bond-theta launches, wall s): the counts are
    set to 0 just before the call and read just after."""
    from optimalcontrolmps_torch.ops import bond_theta as bt
    reset_all_counts()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, bt.bond_theta_launches, time.perf_counter() - t0


def rows_of(path: str) -> int:
    """Rows of a text file of numbers (0 when it is missing)."""
    if not os.path.exists(path):
        return 0
    return np.loadtxt(path, ndmin=2).shape[0]


def check_prep_observables(psi_h) -> dict:
    """The single-particle density matrix of the long chain's U_i prep
    state in complex64 on the card (Hermitian, trace Npart, condensate
    occupation between 1 and Npart), and the shared-environment window
    correlators (ANALYSIS_WINDOW) against pairwise correlation_function."""
    from optimalcontrolmps_torch import observables as obs
    from optimalcontrolmps_torch.sites import op

    A = torch.as_tensor(psi_h.astype(np.complex64), device="cuda")[None]
    d, n = ANALYSIS_D, ANALYSIS_N
    adag, a, num = op("Adag", d), op("A", d), op("N", d)
    C = obs.correlation_matrix(A, adag, a)[0]
    herm = float((C - C.conj().T).abs().max())
    trace = float(torch.diagonal(C).real.sum())
    cond = float(obs.condensate_fraction(A, adag, a)[0])
    start, end = ANALYSIS_WINDOW
    sp, dd, rdd = (x[0] for x in obs.window_correlations(A, a, adag, num,
                                                         start, end))
    eye = np.eye(d + 1)

    def corr(o1, i, o2, j):
        return float(obs.correlation_function(A, o1, i, o2, j)[0].real)

    n0 = corr(num, start, eye, start)
    werr = 0.0
    for k, j in enumerate(range(start + 1, end + 1)):
        ddj = corr(num, start, num, j)
        werr = max(werr, abs(float(sp[k]) - corr(adag, start, a, j)),
                   abs(float(dd[k]) - ddj),
                   abs(float(rdd[k]) - (ddj - n0 * corr(num, j, eye, j))))
    res = {"hermitian_err": herm, "trace": trace, "condensate": cond,
           "window_vs_pairs": werr}
    print(f"analysis prep state (U_i, chi {ANALYSIS_CHI_PREP}, complex64): "
          f"|C - C^H| {herm:.2e}, trace {trace:.6f}, condensate occupation "
          f"{cond:.4f}, window vs pairwise correlators {werr:.2e}")
    if not herm < ANALYSIS_HERM_TOL:
        fail(f"analysis: the density matrix is not Hermitian: {herm}")
    if not abs(trace - n) < ANALYSIS_TRACE_TOL:
        fail(f"analysis: the density matrix's trace is {trace}, not {n}")
    if not 1.0 < cond < n:
        fail(f"analysis: condensate occupation {cond} not in (1, {n})")
    if not werr < ANALYSIS_WINDOW_TOL:
        fail(f"analysis: window_correlations vs pairwise: {werr}")
    return res


def analysis_stage_thetas(psi_h) -> tuple:
    """The bond theta against its twin at the analysis path's stage shapes:
    random inputs (numpy seed 0) at (10 and 9, chi, 8) complex64 for chi
    in ANALYSIS_STAGE_CHIS, and both stages of the U_i prep state padded to
    ANALYSIS_MAXM, as analyze_quench steps it; and the Vidal step's time
    there with eigh's share. Returns (readings, step reading)."""
    from optimalcontrolmps_torch import mps, tebd, vidal

    checks = [theta_reading(*theta_inputs(B, chi, ANALYSIS_D + 1,
                                          torch.complex64),
                            "analysis stage ")
              for chi in ANALYSIS_STAGE_CHIS
              for B in (ANALYSIS_N // 2, (ANALYSIS_N - 1) // 2)]
    chi = ANALYSIS_MAXM
    st = tebd.make_stepper(ANALYSIS_N, ANALYSIS_D, 1.0, ANALYSIS_TSTEP, chi,
                           dtype=torch.complex64, sweep="vidal",
                           device="cuda")
    state = vidal.from_mps(mps.pad_chi(psi_h, chi).astype(np.complex64),
                           device="cuda")
    checks += vidal_stage_thetas(st, state, 1, "analysis")
    return checks, vidal_step_reading(st, state, 1, 3)


def drive_analysis_chain() -> dict:
    """The long chain (N=20, Npart=20, d=7, tstep 5e-3, T = ANALYSIS_T,
    complex64, on the card), every driver through its run() entry into one
    temporary directory with one state cache: prep_states at chi_prep 64;
    analyze_quench --ramp quench at maxBondDim ANALYSIS_MAXM; calculate_
    defects at its own maxBondDim 70 on engine = vidal; analyze_bond_dim at
    ANALYSIS_BOND_DIMS with the gradient. Gated on the physics (particle
    number, entropies, fidelities, discarded weights, files of N_t rows)."""
    from optimalcontrolmps_torch.drivers import (analyze_bond_dim,
                                                 analyze_quench,
                                                 calculate_defects,
                                                 prep_states)

    n, n_t = ANALYSIS_N, int(round(ANALYSIS_T / ANALYSIS_TSTEP)) + 1
    res = {"N": n, "Npart": n, "d": ANALYSIS_D, "tstep": ANALYSIS_TSTEP,
           "T": ANALYSIS_T, "n_steps": n_t, "dtype": "complex64",
           "cuts": ANALYSIS_CUTS, "drivers": {}}
    launches = 0
    with tempfile.TemporaryDirectory() as tmp, DmrgRecorder() as rec:
        cache = os.path.join(tmp, f"L{n}d{ANALYSIS_D}n{n}"
                                  f"chi{ANALYSIS_CHI_PREP}.npz")
        (psi_i_h, _), _, wall = counted(
            prep_states.ensure_boundary_states, n, ANALYSIS_D, n, 1.0, 2.5,
            50.0, ANALYSIS_CHI_PREP, cache, chi_prep=ANALYSIS_CHI_PREP)
        res["drivers"]["prep_states"] = {"wall_s": wall,
                                         "dmrg_states": len(rec.states)}
        res["prep_observables"] = check_prep_observables(psi_i_h)

        def entry(name, fn, *args, **kw):
            nonlocal launches
            d0 = sum(s["s"] for s in rec.states)
            out, k, wall = counted(fn, *args, **kw)
            res["drivers"][name] = {
                "wall_s": wall, "bond_theta_launches": k,
                "dmrg_s": sum(s["s"] for s in rec.states) - d0}
            launches += k
            if not k > 0:
                fail(f"analysis: {name} launched no bond_theta kernel")
            return out

        q = entry("analyze_quench", analyze_quench.run,
                  analysis_config(os.path.join(tmp, "InputQuench"),
                                  maxBondDim=ANALYSIS_MAXM),
                  ramp="quench", out_prefix=os.path.join(tmp, "q_"),
                  state_cache=cache)
        dfx = entry("calculate_defects", calculate_defects.run,
                    analysis_config(os.path.join(tmp, "InputDefects")))
        bd = entry("analyze_bond_dim", analyze_bond_dim.run,
                   analysis_config(os.path.join(tmp, "InputBondDim")),
                   bond_dims=ANALYSIS_BOND_DIMS,
                   out_prefix=os.path.join(tmp, "b_"), state_cache=cache)
        files = {f"q_{f}_Quench.txt": rows_of(os.path.join(
            tmp, f"q_{f}_Quench.txt")) for f in (
                "EntanglementEntropies", "SingleParticleCorr",
                "DensityDensityCorr", "RescaledDensityDensityCorr")}
        for m in ANALYSIS_BOND_DIMS:
            name = f"b_TimeEvolBondDimT{ANALYSIS_T:.1f}maxM{m}.txt"
            files[name] = rows_of(os.path.join(tmp, name))
        schmidt_rows = {m: rows_of(os.path.join(
            tmp, f"b_SchmidtDataT{ANALYSIS_T:.1f}maxM{m}.txt"))
            for m in ANALYSIS_BOND_DIMS}
        res["dmrg_s"] = sum(s["s"] for s in rec.states)
        res["dmrg_states"] = [{"U": s["U"], "chi": int(s["A"].shape[1]),
                               "s": s["s"], "sweeps": len(s["history"])}
                              for s in rec.states]
    npart_err = float(np.abs(dfx["expn"].sum(axis=1) - n).max())
    s_min = min(float(q["entropies"].min()),
                *(float(r["vn_entropy"].min()) for r in bd.values()))
    f_max = max(float(dfx["fids"].max()),
                *(float(r["fids"].max()) for r in bd.values()))
    disc_min = min(float(r["disc"].min()) for r in bd.values())
    grad_ok = all(np.isfinite(r["grad"]).all() for r in bd.values())
    res.update({
        "quench": {"chi": q["chi"], "S_final_max": float(
            q["entropies"][-1].max()), "wall_s": q["wall"]},
        "defects": {"npart_max_err": npart_err, "F_final": float(
            dfx["fids"][-1]), "rho_final": float(dfx["rho"][-1]),
            "f2_final": float(dfx["f2"][-1])},
        "bond_dim": {str(m): {"chi": r["chi"], "F_final": float(
            r["fids"][-1]), "max_disc": float(r["disc"].max()),
            "t_fidelity": r["t_fidelity"], "t_gradient": r["t_gradient"]}
            for m, r in bd.items()},
        "files": files, "schmidt_rows": schmidt_rows,
        "entropy_min": s_min, "fidelity_max": f_max, "disc_min": disc_min,
        "bond_theta_launches": launches})
    res["thetas"], res["step"] = analysis_stage_thetas(psi_i_h)
    print(json.dumps({"analysis_chain": {k: v for k, v in res.items()
                                         if k != "thetas"}}))
    if not npart_err < ANALYSIS_NPART_TOL:
        fail(f"analysis: calculate_defects' particle number off by "
             f"{npart_err}")
    if not s_min >= ANALYSIS_S_FLOOR:
        fail(f"analysis: an entropy is {s_min}")
    if not f_max <= 1.0 + ANALYSIS_F_CEIL:
        fail(f"analysis: a fidelity is {f_max}")
    if not disc_min >= 0.0:
        fail(f"analysis: a discarded weight is {disc_min}")
    if not grad_ok:
        fail("analysis: analyze_bond_dim's gradient is not finite")
    if not all(r == n_t for r in files.values()):
        fail(f"analysis: files without {n_t} rows: {files}")
    res["launches"] = launches
    res["prep_state"] = psi_i_h     # handed to the tensor-parallel phases
    return res


def drive_analysis_shipped(ramp_text: str) -> dict:
    """The shipped file's widths: extend_time_evolution on ip_sector's
    converged ramp with engine = vidal and with engine = sector (complex128,
    chi = 25 = the exact rank bound: the extended fidelities agree to
    EXTEND_VIDAL_SECTOR_TOL), then test_runtimes at its own widths (L=5,
    d=5, maxM 40) at T = RUNTIMES_T, batches 1, 2, 4, 8, with the Hessian: the
    cost agrees across batch sizes to RUNTIMES_COST_REL_TOL."""
    from optimalcontrolmps_torch import config
    from optimalcontrolmps_torch.drivers import (extend_time_evolution,
                                                 test_runtimes)

    res, launches, fids = {}, 0, {}
    tag = f"{example_config().get_real('T'):.1f}"
    with tempfile.TemporaryDirectory() as tmp:
        ramp = os.path.join(tmp, "BHrampInitialFinal.txt")
        with open(ramp, "w") as f:
            f.write(ramp_text)
        n_rows = rows_of(ramp) + 100
        for engine in ("vidal", "sector"):
            path = os.path.join(tmp, f"Input_{engine}")
            config.write_input_file(path, example_config(
                engine=engine).values)
            prefix = os.path.join(tmp, f"{engine}_")
            out, k, wall = counted(extend_time_evolution.run, path, ramp,
                                   out_prefix=prefix)
            rows = {f: rows_of(prefix + f) for f in (
                f"BHrampInitialFinal_extendedT{tag}.txt",
                f"ExpectationN_extendedT{tag}.txt")}
            fids[engine] = (out["fid_init"], out["fid_final"])
            res[f"extend_{engine}"] = {
                "wall_s": wall, "bond_theta_launches": k, "rows": rows,
                "F_final": float(out["fid_final"][-1]),
                "npart_max_err": float(np.abs(out["expn"].sum(axis=1)
                                              - NPART).max())}
            launches += k
    dF = max(float(np.abs(a - b).max())
             for a, b in zip(fids["vidal"], fids["sector"]))
    res["extend_vidal_vs_sector"] = dF
    rt, k, wall = counted(test_runtimes.run, horizons=(RUNTIMES_T,),
                          batches=(1, 2, 4, 8), with_hessian=True)
    launches += k
    costs = np.concatenate(rt["batch_costs"][RUNTIMES_T])
    rt_rel = float(np.abs(costs - costs[0]).max() / abs(costs[0]))
    res["test_runtimes"] = {"wall_s": wall, "bond_theta_launches": k,
                            "grad_s": rt["grad"], "hess_s": rt["hess"],
                            "cost": float(costs[0]), "cost_rel_spread":
                            rt_rel}
    print(json.dumps({"analysis_shipped": res}))
    for engine in ("vidal", "sector"):
        r = res[f"extend_{engine}"]
        if not all(v == n_rows for v in r["rows"].values()):
            fail(f"analysis: extend ({engine}) files: {r['rows']}")
        if not r["npart_max_err"] < 1e-8:
            fail(f"analysis: extend ({engine}) particle number off by "
                 f"{r['npart_max_err']}")
    if not res["extend_vidal"]["bond_theta_launches"] > 0:
        fail("analysis: extend on engine = vidal launched no bond_theta")
    if not dF < EXTEND_VIDAL_SECTOR_TOL:
        fail(f"analysis: extend vidal vs sector fidelities differ by {dF}")
    if not k > 0:
        fail("analysis: test_runtimes launched no bond_theta kernel")
    if not rt_rel < RUNTIMES_COST_REL_TOL:
        fail(f"analysis: test_runtimes' cost moves across batches by "
             f"{rt_rel}")
    res["launches"] = launches
    return res


def drive_analysis_card_vs_cpu() -> dict:
    """analyze_quench (--ramp quench, sites 1..4), calculate_defects
    (engine = vidal) and analyze_bond_dim (ANALYSIS_CARD_CPU_BOND_DIMS) on
    the shipped file's widths at T = ANALYSIS_T, complex128, on the card
    and with device="cpu": fidelities, entropies, correlators and the
    defect columns to ANALYSIS_CARD_CPU_TOL, the gradient to it relative."""
    from optimalcontrolmps_torch import config
    from optimalcontrolmps_torch.drivers import (analyze_bond_dim,
                                                 analyze_quench,
                                                 calculate_defects)

    outs, launches, walls = {}, 0, {}
    for dev in ("cuda", "cpu"):
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "InputFile")
            config.write_input_file(path, example_config(
                T=ANALYSIS_T, engine="vidal").values)
            kw = dict(device=dev, dtype=torch.complex128)
            t0 = time.perf_counter()
            runs = [
                counted(analyze_quench.run, path, ramp="quench",
                        startpoint=1, endpoint=4, state_cache=os.path.join(
                            tmp, "states.npz"),
                        out_prefix=os.path.join(tmp, "q_"), **kw),
                counted(calculate_defects.run, path, device=dev),
                counted(analyze_bond_dim.run, path,
                        bond_dims=ANALYSIS_CARD_CPU_BOND_DIMS,
                        state_cache=os.path.join(tmp, "states.npz"),
                        out_prefix=os.path.join(tmp, "b_"), **kw)]
            walls[dev] = time.perf_counter() - t0
        outs[dev] = [r[0] for r in runs]
        if dev == "cuda":
            launches = sum(r[1] for r in runs)
    (qc, dc, bc), (qh, dh, bh) = outs["cuda"], outs["cpu"]
    diffs = {f"quench_{k}": float(np.abs(qc[k] - qh[k]).max())
             for k in ("entropies", "sp", "dd", "rdd")}
    diffs.update({f"defects_{k}": float(np.abs(dc[k] - dh[k]).max())
                  for k in ("fids", "rho", "f2")})
    for m in ANALYSIS_CARD_CPU_BOND_DIMS:
        for k in ("fids", "s2", "disc"):
            diffs[f"bond_dim_{m}_{k}"] = float(np.abs(bc[m][k]
                                                      - bh[m][k]).max())
        diffs[f"bond_dim_{m}_grad_rel"] = float(
            np.abs(bc[m]["grad"] - bh[m]["grad"]).max()
            / np.abs(bh[m]["grad"]).max())
    res = {"diffs": diffs, "card_s": walls["cuda"], "cpu_s": walls["cpu"],
           "bond_theta_launches": launches}
    print(json.dumps({"analysis_card_vs_cpu": res}))
    worst = max(diffs, key=diffs.get)
    if not diffs[worst] < ANALYSIS_CARD_CPU_TOL:
        fail(f"analysis: card and CPU differ in {worst}: {diffs[worst]}")
    if not launches > 0:
        fail("analysis: the card runs launched no bond_theta kernel")
    res["launches"] = launches
    return res


# ---------------------------------------------------------------------------
# the multi-device phases and the host library
# ---------------------------------------------------------------------------

def counted_part(record: dict, name: str, fn):
    """fn() with every launch counter set to 0 just before and read just
    after; its launches and wall time go into record[name]."""
    reset_all_counts()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    record[name] = {"launches": launch_counts(),
                    "wall_s": time.perf_counter() - t0}
    return out


def par_sector(dev):
    """The flagship problem (complex64) and its PAR_BATCH seeds."""
    from optimalcontrolmps_torch import flagship
    prob = flagship.make_problem(dev)
    return prob, flagship.multistart_coeffs(PAR_BATCH, prob.basis.M)


def par_multistart(prob, cs, mesh, max_iter: int):
    from optimalcontrolmps_torch.parallel.multistart import multistart_lbfgs
    return multistart_lbfgs(prob.st, prob.psi_i, prob.psi_f, prob.basis, cs,
                            gamma=prob.gamma, max_iter=max_iter, tol=PAR_TOL,
                            mesh=mesh, exact=True)


def par_train_problem():
    """The shipped file's MPS problem at T = PAR_TRAIN_T, and its
    PAR_TRAIN_B starts (lane 0 zero, numpy seed 7)."""
    from optimalcontrolmps_torch import flagship
    from optimalcontrolmps_torch.drivers import common
    p = common.build_problem(example_config(engine="mps", T=PAR_TRAIN_T),
                             engine="mps")
    return p, flagship.multistart_coeffs(PAR_TRAIN_B, p.M).astype(np.float64)


def par_train(p, cs, mesh):
    """(costs (B,), best lane, Hessian diagonal) of one train step."""
    from optimalcontrolmps_torch.parallel.comm import argmin
    from optimalcontrolmps_torch.parallel.multistart import make_train_step
    step, shard = make_train_step(p.stepper, p.psi_i, p.psi_f, p.basis,
                                  gamma=p.gamma, lr=10.0, mesh=mesh,
                                  with_hessian=True)
    C = shard(cs) if mesh is not None else torch.as_tensor(
        cs, device=p.basis.f.device)
    _, costs, _, hdiag = step(C)
    return costs, argmin(costs), hdiag


def tp_problem(B_h, lam_h, dev):
    """The N = 20, d = 7, chi = 128 complex64 Vidal stepper, the prep
    state (host arrays) on `dev` and TP_STEPS + 1 controls."""
    from optimalcontrolmps_torch import seeds, tebd, vidal
    st = tebd.make_stepper(ANALYSIS_N, ANALYSIS_D, 1.0, ANALYSIS_TSTEP,
                           ANALYSIS_MAXM, dtype=torch.complex64,
                           sweep="vidal", device=dev)
    state = vidal.VidalState(torch.as_tensor(B_h, device=dev),
                             torch.as_tensor(lam_h, device=dev))
    u = torch.as_tensor(seeds.linspace(2.5, 50.0, TP_STEPS + 1),
                        dtype=torch.float32, device=dev)
    return st, state, u


def tp_agreement(B_tp, lam_tp, ref) -> dict:
    """|<tp|ref>| / (|tp| |ref|) - 1 by an MPS contraction, and the
    largest Schmidt-value difference, where it sits and how many values
    are more than TP_SCHMIDT_TOL apart, of a psi(T) against ref."""
    from optimalcontrolmps_torch import mps, vidal
    A = torch.as_tensor(B_tp, device=ref.B.device)[None]
    R = ref.B[None]
    ov = float(torch.abs(mps.overlap(R, A))[0]
               / (mps.norm(A)[0] * mps.norm(R)[0]))
    lam_ref = vidal.schmidt_values(ref)
    d = np.abs(np.sort(np.asarray(lam_tp), axis=-1)[..., ::-1] - lam_ref)
    worst = np.unravel_index(int(np.argmax(d)), d.shape)
    return {"overlap_minus_1": ov - 1.0, "schmidt_max_diff": float(d.max()),
            "worst_bond_index": [int(i) for i in worst],
            "worst_ref_value": float(lam_ref[worst]),
            "values_off_by_1e-5": int((d > TP_SCHMIDT_TOL).sum()),
            "values": int(d.size)}


def two_rank_work(rank, world, B_h, lam_h):
    """A rank of the 2-rank gloo world, both ranks computing on cuda:0:
    the sector multistart (check and full solve), the train step on a
    (1, 2) mesh, the tensor-parallel rollout and the dry run; host results
    and launches."""
    from optimalcontrolmps_torch import vidal
    from optimalcontrolmps_torch.parallel.dryrun import dryrun_multidevice
    from optimalcontrolmps_torch.parallel.mesh import make_mesh
    from optimalcontrolmps_torch.precision import enforce_matmul_precision

    enforce_matmul_precision()
    m_batch = make_mesh(world)
    m_rows = make_mesh(world, rows=world)
    parts = {}
    out = {"rank": rank, "device": str(m_batch.device), "parts": parts}
    prob, cs = par_sector(m_batch.device)
    r = counted_part(parts, "sector_check", lambda: par_multistart(
        prob, cs, m_batch, PAR_CHECK_ITERS))
    out["sector_check"] = r.all_costs.cpu().numpy()
    r = counted_part(parts, "sector_solve", lambda: par_multistart(
        prob, cs, m_batch, PAR_SOLVE_ITERS))
    out["sector_solve"] = {"best": float(r.best_cost),
                           "all_costs": r.all_costs.cpu().numpy(),
                           "converged": int(r.converged.sum())}
    p, cs_t = par_train_problem()
    costs, k, hdiag = counted_part(parts, "train_step",
                                   lambda: par_train(p, cs_t, m_rows))
    out["train_step"] = {"costs": costs.cpu().numpy(), "best_lane": k,
                         "hdiag": hdiag.cpu().numpy()}
    st, state, u = tp_problem(B_h, lam_h, m_rows.device)
    psiT = counted_part(parts, "tp_rollout", lambda: vidal.rollout_final_tp(
        st, state, u, m_rows))
    out["tp_rollout"] = {"B": psiT.B.cpu().numpy(),
                         "lam": psiT.lam.cpu().numpy()}
    out["dryrun"] = counted_part(parts, "dryrun",
                                 lambda: dryrun_multidevice(m_batch))
    return out


def sum_launches(parts: dict) -> dict:
    total = {k: 0 for k in ("sector_chain_fwd", "sector_chain_bwd",
                            "bond_theta")}
    for part in parts.values():
        for k, v in part["launches"].items():
            total[k] += v
    return total


def check_dryrun(d: dict, label: str) -> None:
    ok = all(d[k]["finite"] for k in ("train_step", "sector_lbfgs",
                                      "interior_point", "tp_rollout"))
    if not (ok and d["train_step"]["hdiag"] == [9]
            and d["sector_lbfgs"]["best_cost"]
            == min(d["sector_lbfgs"]["all_costs"])):
        fail(f"{label}: dryrun_multidevice: {d}")


def drive_parallel_1rank(prep_state) -> dict:
    """A world of one NCCL rank on cuda:0 (init_distributed, the card's
    default) through every sharded entry: the sector multistart (sharded =
    unsharded, bitwise), the train step (Hessian diagonal = engine.hessian
    to PAR_HESS_REL_TOL), the tensor-parallel rollout (= vidal.rollout_final,
    TP_OV_TOL / TP_SCHMIDT_TOL), the bond theta at TP_THETA_SHAPES, the dry
    run and scaling_bench. Returns the references the 2-rank phase is held
    against, the launches and the readings."""
    import torch.distributed as dist

    from optimalcontrolmps_torch import engine, mps, vidal
    from optimalcontrolmps_torch.drivers import scaling_bench
    from optimalcontrolmps_torch.parallel.dryrun import dryrun_multidevice
    from optimalcontrolmps_torch.parallel.mesh import (init_distributed,
                                                       make_mesh)
    from optimalcontrolmps_torch.parallel.multistart import (
        _group_cost_and_grad)

    world, _ = init_distributed()
    if not (world == 1 and dist.get_backend() == "nccl"):
        fail(f"parallel_1rank: world {world}, {dist.get_backend()}")
    m = make_mesh()
    dev = m.device
    parts, res = {}, {"backend": dist.get_backend(), "device": str(dev),
                      "mesh": list(m.shape)}

    prob, cs = par_sector(dev)
    t0 = time.perf_counter()
    ref = par_multistart(prob, cs, None, PAR_CHECK_ITERS)
    res["sector_unsharded_s"] = time.perf_counter() - t0
    r = counted_part(parts, "sector_check", lambda: par_multistart(
        prob, cs, m, PAR_CHECK_ITERS))
    lane_diff = float(torch.max(torch.abs(r.all_costs - ref.all_costs)))
    J0 = float(_group_cost_and_grad(
        prob.st, prob.psi_i, prob.psi_f, prob.basis, prob.gamma,
        torch.zeros((1, prob.basis.M), device=dev), exact=True)[0][0])
    res["sector"] = {"batch": PAR_BATCH, "iters": PAR_CHECK_ITERS,
                     "lane_max_abs_diff": lane_diff,
                     "best": float(r.best_cost), "J_c0": J0}

    p, cs_t = par_train_problem()
    costs, k, hdiag = counted_part(parts, "train_step",
                                   lambda: par_train(p, cs_t, m))
    t0 = time.perf_counter()
    u_best = p.basis.convert_control(torch.as_tensor(cs_t[k], device=dev))
    H = engine.hessian(p.stepper, p.psi_i, p.psi_f, u_best, p.gamma)
    hd_ref = torch.diagonal(H)
    res["hessian_ref_s"] = time.perf_counter() - t0
    hd_rel = float(torch.max(torch.abs(hdiag - hd_ref))
                   / torch.max(torch.abs(hd_ref)))
    res["train_step"] = {"B": PAR_TRAIN_B, "n_t": int(hdiag.shape[0]),
                         "best_lane": k, "best": float(costs[k]),
                         "hdiag_rel_diff": hd_rel}

    A = mps.pad_chi(prep_state, ANALYSIS_MAXM).astype(np.complex64)
    t0 = time.perf_counter()
    state_h = vidal.from_mps(A, device=dev)
    B_h, lam_h = state_h.B.cpu().numpy(), state_h.lam.cpu().numpy()
    res["from_mps_s"] = time.perf_counter() - t0
    st, state, u = tp_problem(B_h, lam_h, dev)
    t0 = time.perf_counter()
    tp_ref = vidal.rollout_final(st, state, u)
    torch.cuda.synchronize(dev)
    res["tp_ref_s"] = time.perf_counter() - t0
    psiT = counted_part(parts, "tp_rollout", lambda: vidal.rollout_final_tp(
        st, state, u, m))
    res["tp_rollout"] = tp_agreement(psiT.B, psiT.lam.cpu().numpy(), tp_ref)
    # the witness: the unsharded rollout with its stage batches doubled
    # (two identical lanes) against itself
    two = vidal.rollout_final(st, state, torch.stack([u, u]))
    res["tp_batch_witness"] = tp_agreement(two.B[1], two.lam[1].cpu().numpy(),
                                           tp_ref)

    thetas = [theta_reading(*theta_inputs(b, chi, pp, torch.complex64),
                            "TP share ")
              for b, chi, pp in TP_THETA_SHAPES]
    res["dryrun"] = counted_part(parts, "dryrun",
                                 lambda: dryrun_multidevice(m))
    res["scaling_bench"] = counted_part(parts, "scaling_bench",
                                        lambda: scaling_bench.run())
    dist.destroy_process_group()
    res["parts"] = parts
    res["launches"] = sum_launches(parts)
    print(json.dumps({"parallel_1rank": res}))

    if not lane_diff == 0.0:
        fail(f"parallel_1rank: sharded multistart differs from unsharded "
             f"by {lane_diff}")
    if not float(r.best_cost) == float(r.all_costs.min()):
        fail("parallel_1rank: best_cost is not min(all_costs)")
    if not hd_rel <= PAR_HESS_REL_TOL:
        fail(f"parallel_1rank: Hessian diagonal off by {hd_rel} relative")
    tp = res["tp_rollout"]
    if not (abs(tp["overlap_minus_1"]) <= TP_OV_TOL
            and tp["schmidt_max_diff"] <= TP_SCHMIDT_TOL):
        fail(f"parallel_1rank: tensor-parallel rollout: {tp}")
    check_dryrun(res["dryrun"], "parallel_1rank")
    rows = res["scaling_bench"]["rows"]
    if not (len(rows) == 1 and rows[0]["ramps_per_s"] > 0):
        fail(f"parallel_1rank: scaling_bench rows {rows}")
    for name in ("sector_check", "train_step", "tp_rollout"):
        if not sum(parts[name]["launches"].values()) > 0:
            fail(f"parallel_1rank: {name} launched no kernel")
    return {"res": res, "thetas": thetas, "sector_ref": ref.all_costs,
            "J0": J0, "hd_ref": hd_ref, "tp_ref": tp_ref, "B_h": B_h,
            "lam_h": lam_h}


def drive_parallel_2rank(one: dict) -> dict:
    """Two spawned gloo ranks, both computing on cuda:0 (two_rank_work),
    held against the one-rank phase's unsharded references."""
    from optimalcontrolmps_torch.parallel.spawn import run_world

    t0 = time.perf_counter()
    # half the host's cores each: two ranks with a full OpenMP pool each
    # spin against one another on the host's side of the work
    threads = max(1, (os.cpu_count() or 2) // 2)
    outs = run_world(two_rank_work, 2, backend="gloo", device="cuda:0",
                     args=(one["B_h"], one["lam_h"]), threads=threads)
    wall = time.perf_counter() - t0
    ref = one["sector_ref"].cpu().numpy()
    hd_ref = one["hd_ref"]
    res = {"world": 2, "backend": "gloo", "wall_s": wall, "ranks": []}
    for o in outs:
        lane = float(np.max(np.abs(o["sector_check"] - ref)
                            / np.maximum(np.abs(ref), 1e-30)))
        solve = o["sector_solve"]
        hd = torch.as_tensor(o["train_step"]["hdiag"], device=hd_ref.device)
        hd_rel = float(torch.max(torch.abs(hd - hd_ref))
                       / torch.max(torch.abs(hd_ref)))
        tp = tp_agreement(o["tp_rollout"]["B"], o["tp_rollout"]["lam"],
                          one["tp_ref"])
        res["ranks"].append({
            "rank": o["rank"], "device": o["device"],
            "sector_check_lane_rel_diff": lane,
            "sector_solve": {"best": solve["best"],
                             "min_all": float(solve["all_costs"].min()),
                             "converged": solve["converged"],
                             "J_c0": one["J0"]},
            "train_step_hdiag_rel_diff": hd_rel, "tp_rollout": tp,
            "parts": o["parts"]})
        check_dryrun(o["dryrun"], f"parallel_2rank rank {o['rank']}")
    res["launches"] = sum_launches({f"{i}_{k}": v for i, o in enumerate(outs)
                                    for k, v in o["parts"].items()})
    print(json.dumps({"parallel_2rank": res}))
    for r in res["ranks"]:
        if not r["sector_check_lane_rel_diff"] <= PAR_LANE_REL_TOL:
            fail(f"parallel_2rank: lanes differ from the unsharded call: "
                 f"{r['sector_check_lane_rel_diff']}")
        sv = r["sector_solve"]
        if not (sv["best"] == sv["min_all"] and sv["best"] < sv["J_c0"]):
            fail(f"parallel_2rank: full solve {sv}")
        if not r["train_step_hdiag_rel_diff"] <= PAR_HESS_REL_TOL:
            fail(f"parallel_2rank: Hessian diagonal off by "
                 f"{r['train_step_hdiag_rel_diff']} relative")
        tp = r["tp_rollout"]
        if not (abs(tp["overlap_minus_1"]) <= TP_OV_TOL
                and tp["schmidt_max_diff"] <= TP_SCHMIDT_TOL_SPLIT):
            fail(f"parallel_2rank: tensor-parallel rollout: {tp}")
        for name in ("sector_check", "sector_solve", "train_step",
                     "tp_rollout"):
            if not sum(r["parts"][name]["launches"].values()) > 0:
                fail(f"parallel_2rank: {name} launched no kernel")
    if not (outs[0]["sector_solve"]["best"]
            == outs[1]["sector_solve"]["best"]):
        fail("parallel_2rank: the ranks disagree on the best cost")
    return res


def drive_native() -> dict:
    """The host library: built with g++, then NATIVE_CASES enumerated by it
    and by the Python twin (exact), the first case's COO Hamiltonian
    against the twin's (indices exact, values to NATIVE_COO_TOL), with the
    wall time of both routes."""
    from optimalcontrolmps_torch import groundstate, native
    from optimalcontrolmps_torch.ops import _build

    _build.load_native()    # built at first use, by the phases before
    log = _build.build_log.get("ocmps_native", {})
    res = {"build_s": log.get("seconds"), "build_cmd": log.get("cmd"),
           "cases": []}
    for case in NATIVE_CASES:
        t0 = time.perf_counter()
        st_n, fl_n = native.sector_basis(*case)
        t_nat = time.perf_counter() - t0
        t0 = time.perf_counter()
        st_p, fl_p = groundstate.sector_basis_python(*case)
        t_py = time.perf_counter() - t0
        row = {"L_d_npart": list(case), "states": int(st_n.shape[0]),
               "enumerate_native_s": t_nat, "enumerate_python_s": t_py,
               "enumeration_equal": bool(np.array_equal(st_n, st_p)
                                         and np.array_equal(fl_n, fl_p))}
        if case == NATIVE_CASES[0]:
            t0 = time.perf_counter()
            r, c, v, n = native.sector_hamiltonian_coo(*case, 1.0, 2.5)
            row["coo_native_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            pr, pc, pv, pn = groundstate.sector_hamiltonian_coo_python(
                *case, 1.0, 2.5)
            row["coo_python_s"] = time.perf_counter() - t0
            row["nnz"] = int(r.size)
            row["coo_index_equal"] = bool(n == pn and np.array_equal(r, pr)
                                          and np.array_equal(c, pc))
            row["coo_max_abs_diff"] = float(np.abs(v - pv).max()) \
                if v.shape == pv.shape else float("inf")
        res["cases"].append(row)
    print(json.dumps({"native": res}))
    counts = {(10, 4, 10): 72403, (12, 5, 12): 1203632}
    for row in res["cases"]:
        if not (row["enumeration_equal"]
                and row["states"] == counts[tuple(row["L_d_npart"])]):
            fail(f"native: enumeration {row}")
    first = res["cases"][0]
    if not (first["coo_index_equal"]
            and first["coo_max_abs_diff"] <= NATIVE_COO_TOL):
        fail(f"native: COO Hamiltonian {first}")
    return res


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False; this script needs a GPU")

    from optimalcontrolmps_torch.ops import _build
    from optimalcontrolmps_torch.precision import enforce_matmul_precision

    enforce_matmul_precision()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}")
    batch = int(os.environ.get("SMOKE_BATCH", "4096"))
    phases = Phases()

    _build.build_all()
    for name, log in _build.build_log.items():
        print(f"build {name}: nvcc {log['seconds']:.2f} s: {log['cmd']}")
        for line in log["ptxas"].splitlines():
            # the C7514 note is ptxas serializing wgmma groups
            if any(k in line for k in ("registers", "Compiling", "spill",
                                       "C7514")):
                print(f"  ptxas: {line.strip()}")
    phases.done("build")

    kernels = check_sector_chain(batch)
    phases.done("sector kernels vs twins")
    kernels.update(check_bond_theta())
    phases.done("bond_theta kernel vs twin")
    check_golden()
    phases.done("MPS golden")
    _, mps_card = check_card_vs_cpu()
    phases.done("card vs CPU")

    sector_launches = drive_sector(batch, kind, smi)
    phases.done("sector main path (flagship.solve_flagship)")
    kernels["sector_chain_fwd"]["launches"] = sector_launches["fwd"]
    kernels["sector_chain_bwd"]["launches"] = sector_launches["bwd"]

    kernels["bond_theta"]["launches"] = drive_mps(LANES)
    phases.done("MPS main path (optimize_ramp.run, engine = mps)")

    ip_sector = drive_ip_sector()
    phases.done("ip_sector (optimize_ramp.run, useBFGS = no)")
    drive_ip_flagship_cold()
    phases.done("ip_flagship_cold (minimize_interior_point)")
    ip_mps = drive_ip_mps()
    kernels["bond_theta"]["launches"] += ip_mps["launches"]
    phases.done("ip_mps (optimize_ramp.run, engine = mps, jit/host/resume)")
    drive_amoeba()
    phases.done("amoeba (amoeba_opt.run)")

    bt = kernels["bond_theta"]
    vx = drive_vidal_exact(mps_card, ip_mps["f_after_iteration_1"]["host"])
    phases.done("vidal_exact (engine = vidal, ipMode = host)")
    drive_dmrg_exact()
    phases.done("dmrg_exact (dmrg_ground_state)")
    vs = drive_vidal_scaled()
    phases.done("vidal_scaled (the reference-scale config, DMRG states)")
    an = drive_analysis_chain()
    phases.done("analysis_chain (prep_states, analyze_quench, "
                "calculate_defects, analyze_bond_dim at N=20, d=7)")
    ash = drive_analysis_shipped(ip_sector["ramp_text"])
    phases.done("analysis_shipped (extend_time_evolution vidal/sector, "
                "test_runtimes)")
    acc = drive_analysis_card_vs_cpu()
    phases.done("analysis_card_vs_cpu (three drivers at L=5, complex128)")
    one = drive_parallel_1rank(an["prep_state"])
    phases.done("parallel_1rank (a one-rank NCCL world: multistart, train "
                "step, TP rollout, dry run, scaling_bench)")
    two = drive_parallel_2rank(one)
    phases.done("parallel_2rank (two gloo ranks on cuda:0)")
    drive_native()
    phases.done("native (the host library against its Python twin)")
    for r in (vx, vs, an, ash, acc):
        bt["launches"] += r["launches"]
    for r in (one["res"], two):
        for k, v in r["launches"].items():
            kernels[k]["launches"] += v
    for r in (vx, vs, an):
        bt["checks"] += r["thetas"]
    bt["checks"] += one["thetas"]
    bt["max_abs_err"] = max(c["max_abs_err"] for c in bt["checks"])

    print(json.dumps({"kernels": [kernels[k] for k in (
        "sector_chain_fwd", "sector_chain_bwd", "bond_theta")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
