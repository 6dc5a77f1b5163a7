"""Unit: one run of the port's AnalyzeQuench driver
(`drivers/analyze_quench.run`, ramp "quench") through its normal entry,
both DMRG boundary states included.

Set-up writes the InputFile the driver reads from the configuration's
keys (N, Npart, d, tstep, T, maxBondDim) into a temporary directory. Each
unit hands the driver a state cache that does not exist yet, so
`prep_states.ensure_boundary_states` runs both ground-state searches (U
initial and final, at chi_prep) on every unit, as the reference's driver
does on every run; then the driver quenches the initial state at the
quench's chi and records each bond's entropy and the window's correlators
at every step, and writes its four files there. Every unit does the same
work: the run's seed only picks which units the check samples.

The program's spans (`profiling.collect_spans`) and counters (DMRG sweeps,
H_eff applications and host syncs, SVDs and `eigh` calls by size, Vidal
steps) go into the unit's `spans` and `counts`, each only where the
program has it. With tracing on, the unit keeps the profiler the harness
starts (`torch.profiler.profile.start` is wrapped while the unit is set
up) and its probes read the device time of cuSOLVER's SVD kernels off that
trace.

The check compares what the timed run produced: both boundary states'
energies and particle numbers against the plain reference's searches
(reference/dmrg.py at the same U, chi, sweeps and Krylov depth), and every
step's entropies and correlators against the plain reference's quench from
the program's own initial state (reference/quench.py), in complex128.
"""

from __future__ import annotations

import bisect
import contextlib
import inspect
import os
import shutil
import sys
import tempfile
from types import SimpleNamespace

import numpy as np
import torch

from optimalcontrolmps_torch import dmrg, groundstate, mps as mpslib
from optimalcontrolmps_torch import observables
from optimalcontrolmps_torch import profiling, tebd, vidal
from optimalcontrolmps_torch.config import write_input_file
from optimalcontrolmps_torch.drivers import analyze_quench, common
from optimalcontrolmps_torch.ops import trunc
from optimalcontrolmps_torch.precision import enforce_matmul_precision
from optimalcontrolmps_torch.sites import op

from benchmark import harness, peaks
from benchmark.reference import dmrg as ref_dmrg
from benchmark.reference import observables as ref_obs
from benchmark.reference import quench as ref_quench
from benchmark.reference import sector as ref

# every key of the InputFile the driver reads
INPUT_KEYS = ("N", "Npart", "d", "tstep", "T", "maxBondDim")
DTYPES = {"double": torch.complex128, "single": torch.complex64}
COUNTED = (dmrg, trunc, vidal)
# cuSOLVER's SVD kernels by name (read off a trace of one gesvd of a
# 512 x 512 complex128 theta on an H100): the bidiagonal reduction and its
# Householder vectors, and the rotations of the bidiagonal QR
SVD_KERNELS = ("gesvd", "gebrd", "gebd2", "labrd", "larfg", "lacgv",
               "bdsqr", "lasr", "orgbr", "ungbr", "ormbr", "unmbr")


def _check_config(cfg: dict) -> None:
    """The configuration's fixed physics, ramp and search are the
    driver's."""
    search = inspect.signature(dmrg.dmrg_ground_state).parameters
    want = {"J": common.J_HOP, "U_initial": common.U_INITIAL,
            "U_final": common.U_FINAL, "ramp": "quench",
            "dmrg": {"sweeps": inspect.signature(
                         groundstate.initialize_state)
                     .parameters["n_sweeps"].default,
                     "krylov": search["krylov"].default,
                     "number_penalty": search["number_penalty"].default,
                     "e_tol": search["e_tol"].default}}
    bad = {k: (cfg[k], v) for k, v in want.items() if cfg[k] != v}
    if bad:
        raise ValueError(f"the driver is built for other values: {bad} "
                         f"(config, program)")


def setup(cfg, traffic, seed, device, spans):
    _check_config(cfg)
    enforce_matmul_precision()
    dtype = DTYPES[cfg["precision"]]
    ctx = SimpleNamespace(cfg=cfg, tr=traffic, seed=seed, device=device,
                          dtype=dtype, profilers=[],
                          cnp=np.complex128 if dtype == torch.complex128
                          else np.complex64)
    ctx.tmp = tempfile.mkdtemp(prefix="prep_quench.")
    ctx.inp = os.path.join(ctx.tmp, "InputFile")
    write_input_file(ctx.inp, {k: cfg[k] for k in INPUT_KEYS})
    ctx.chi = ref_quench.quench_chi(cfg)
    _tap_profiler(ctx)
    _warm_up(ctx)
    return ctx


def _tap_profiler(ctx) -> None:
    """Keep every torch.profiler.profile started from now until release
    (the harness's, when it traces), for `probes`."""
    start = torch.profiler.profile.start

    def kept(prof):
        ctx.profilers.append(prof)
        return start(prof)

    ctx.untap = lambda: setattr(torch.profiler.profile, "start", start)
    torch.profiler.profile.start = kept


def _warm_up(ctx) -> None:
    """One sweep at chi_prep from the product state (the Lanczos and the
    SVD split at the search's last shapes), one Vidal step at the quench's
    chi and one measurement: the kernel builds, the solver handles and
    the allocator's blocks. Nothing is compiled."""
    cfg = ctx.cfg
    L, d = cfg["N"], cfg["d"]
    A, _ = dmrg.dmrg_ground_state(L, d, cfg["Npart"], cfg["J"],
                                  cfg["U_initial"], cfg["chi_prep"],
                                  n_sweeps=1, schedule=[cfg["chi_prep"]],
                                  device=ctx.device)
    st = tebd.make_stepper(L, d, cfg["J"], cfg["tstep"], ctx.chi,
                           dtype=ctx.dtype, sweep="vidal", device=ctx.device)
    vi = vidal.from_mps(mpslib.pad_chi(A.cpu().numpy(), ctx.chi)
                        .astype(ctx.cnp), device=ctx.device)
    u = torch.tensor(float(cfg["U_final"]), dtype=ctx.dtype.to_real(),
                     device=ctx.device)
    s = vidal.vidal_step(st, vidal.VidalState(vi.B[None], vi.lam[None]),
                         u, u)
    start, end = cfg["window"]
    observables.window_correlations(s.B, op("A", d), op("Adag", d),
                                    op("N", d), start, end)
    vidal.bond_vn_entropy(s)


def _counts() -> dict:
    """The program's counters, each where the program has it."""
    out = {"vidal_steps": vidal.steps,
           "eigh_calls": dict(trunc.eigh_calls)}
    for name in ("sweeps", "matvecs", "host_syncs"):
        if hasattr(dmrg, name):
            out["dmrg_" + name] = getattr(dmrg, name)
    if hasattr(trunc, "svd_calls"):
        out["svd_calls"] = {f"{m}x{n}": c
                            for (m, n), c in trunc.svd_calls.items()}
    return out


def run(ctx, k, spans):
    for mod in COUNTED:
        if hasattr(mod, "reset_counts"):
            mod.reset_counts()
    cache = os.path.join(ctx.tmp, f"states_{k}.npz")
    out_prefix = os.path.join(ctx.tmp, f"unit{k}_")
    start, end = ctx.cfg["window"]
    with profiling.collect_spans(ctx.device) as prog:
        with spans("analyze_quench"), \
                contextlib.redirect_stdout(sys.stderr):
            res = analyze_quench.run(ctx.inp, ramp="quench",
                                     out_prefix=out_prefix, dtype=ctx.dtype,
                                     startpoint=start, endpoint=end,
                                     chi_prep=ctx.cfg["chi_prep"],
                                     state_cache=cache, device=ctx.device)
    spans.seconds.update(prog)
    # both boundary states as the driver's cache holds them: the initial
    # one the quench started from and the final one, searched in the same
    # unit (a driver that does not name its cache wrote them where told)
    with np.load(res.get("state_cache", cache)) as z:
        psi_i, psi_f = z["psi_i"], z["psi_f"]
    for name in os.listdir(ctx.tmp):
        if name.startswith((f"unit{k}_", f"states_{k}.")):
            os.remove(os.path.join(ctx.tmp, name))
    ctx.psi_i = psi_i
    return {"work": {"solves": 1}, "counts": _counts(),
            "answers": {"psi_i": psi_i, "psi_f": psi_f,
                        "S": np.asarray(res["entropies"], np.float64),
                        "sp": np.asarray(res["sp"], np.float64),
                        "dd": np.asarray(res["dd"], np.float64),
                        "rdd": np.asarray(res["rdd"], np.float64)}}


def _svd_device_seconds(profs) -> dict | None:
    """Device seconds of every device operation, and of cuSOLVER's SVD:
    the kernels named as its own (`SVD_KERNELS`), on whatever thread they
    were launched, and every operation launched from inside an SVD
    operator (its BLAS calls and copies) on the profiled thread; from the
    kept profilers' traces."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, ops = [], []
    for prof in profs:
        results = getattr(prof.profiler, "kineto_results", None)
        if results is None:
            continue
        for e in results.events():
            if e.device_type() == cuda:
                if not e.is_user_annotation():
                    dev.append((e.name(), e.duration_ns(),
                                e.linked_correlation_id()))
            elif e.linked_correlation_id() == 0:
                ops.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.name(), e.correlation_id(),
                            e.start_thread_id()))
    total = sum(d for _, d, _ in dev)
    if total == 0:
        return None
    launched = {c: (s, th) for s, _, _, c, th in ops}
    # each thread's SVD operators, merged into sorted disjoint intervals
    inside = {}
    for s, e, n, _, th in sorted(o for o in ops if "svd" in o[2]):
        iv = inside.setdefault(th, [])
        if iv and s <= iv[-1][1]:
            iv[-1][1] = max(iv[-1][1], e)
        else:
            iv.append([s, e])
    starts = {th: [s for s, _ in iv] for th, iv in inside.items()}

    def in_svd(corr):
        at = launched.get(corr)
        if at is None or at[1] not in inside:
            return False
        k = bisect.bisect_right(starts[at[1]], at[0]) - 1
        return k >= 0 and at[0] <= inside[at[1]][k][1]

    named = {}
    svd, kernels = 0, {}
    for name, d, corr in dev:
        if name not in named:
            named[name] = any(k in name.lower() for k in SVD_KERNELS)
        if named[name] or in_svd(corr):
            svd += d
            short = name.split("<")[0].split("(")[0].replace("void ", "")
            kernels[short] = kernels.get(short, 0) + 1
    return {"device_s": total / 1e9, "svd_s": svd / 1e9,
            "kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1]))}


def probes(ctx):
    """CUDA-event times of the bond theta at the quench's stage shapes
    (even and odd bonds of the last unit's initial state at the quench's
    chi, in the configuration's precision), and the SVD kernels' device
    time in the profiled window."""
    from optimalcontrolmps_torch.ops.bond_theta import bond_theta
    B = vidal.from_mps(mpslib.pad_chi(ctx.psi_i, ctx.chi).astype(ctx.cnp),
                       device=ctx.device).B
    L, chi, p, _ = B.shape
    st = tebd.make_stepper(L, ctx.cfg["d"], ctx.cfg["J"], ctx.cfg["tstep"],
                           chi, dtype=ctx.dtype, sweep="vidal",
                           device=ctx.device)
    out = []
    for parity in (0, 1):
        bonds = list(range(parity, L - 1, 2))
        Bi = torch.stack([B[b] for b in bonds])
        Bj = torch.stack([B[b + 1] for b in bonds])
        ms = harness.cuda_ms(lambda: bond_theta(Bi, Bj, st.gate_fwd), 50)
        out.append({"B": len(bonds), "chi": chi, "p": p, "ms": ms,
                    "bound_ms": peaks.bond_theta_ms(
                        len(bonds), chi, p, ctx.dtype == torch.complex128)})
    return {"bond_theta": out, "svd": _svd_device_seconds(ctx.profilers)}


def release(ctx):
    ctx.untap()
    shutil.rmtree(ctx.tmp, ignore_errors=True)
    ctx.__dict__.clear()


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - b).max() / np.abs(b).max())


def check(cfg, traffic, seed, answers, device, control: bool = False):
    """For `check_units` units drawn from the seed:
    prep_energy_gap: |<H>(psi) - E_ref| / |E_ref|, the larger over the
    unit's two boundary states (psi_i at U_initial, psi_f at U_final), <H>
    contracted by the reference with reference/dmrg.mpo at that U (its
    number penalty included, as in the search), E_ref the reference's
    search at that U and chi_prep; prep_number_gap: |<N_tot>(psi) -
    Npart|, the larger over both states;
    entropy_gap: max |S - S_ref| over every bond and step;
    corr_gap: max |c - c_ref| / max |c_ref| of each correlator row over
    every step, the largest of the three. S_ref and c_ref: the reference's
    quench from the unit's initial state in complex128. control=True puts
    the reference one precision below the stated one in the program's
    place: a complex64 search for each boundary state, the quench with
    TF32 products (float32 for a double configuration) from the same
    state."""
    L, d = cfg["N"], cfg["d"]
    dm = cfg["dmrg"]
    states = {}
    for key, U in (("psi_i", cfg["U_initial"]), ("psi_f", cfg["U_final"])):
        W = ref_dmrg.mpo(L, d, cfg["J"], U, cfg["Npart"],
                         dm["number_penalty"])
        e_ref = ref_quench.ground_state(cfg, U, cfg["chi_prep"],
                                        device=device)[1]
        low = (ref_quench.ground_state(cfg, U, cfg["chi_prep"],
                                       torch.complex64, device)[0]
               if control else None)
        states[key] = (W, e_ref, low)
    low = ref.TF32 if cfg["precision"] == "single" else ref.F32
    gaps = dict.fromkeys(("prep_energy_gap", "prep_number_gap",
                          "entropy_gap", "corr_gap"), 0.0)
    for i in harness.sample(seed, 3, len(answers), traffic["check_units"]):
        a = answers[i]
        for key, (W, e_ref, psi_low) in states.items():
            A = torch.as_tensor(a[key] if psi_low is None else psi_low,
                                device=device)
            e = ref_obs.mpo_expectation(A, W)
            gaps["prep_energy_gap"] = max(gaps["prep_energy_gap"],
                                          abs(e - e_ref) / abs(e_ref))
            gaps["prep_number_gap"] = max(
                gaps["prep_number_gap"],
                abs(ref_obs.total_number(A, d) - cfg["Npart"]))
        want = ref_quench.quench(cfg, a["psi_i"], device=device)
        got = (ref_quench.quench(cfg, a["psi_i"], low, device) if control
               else a)
        gaps["entropy_gap"] = max(gaps["entropy_gap"], float(
            np.abs(got["S"] - want["S"]).max()))
        gaps["corr_gap"] = max([gaps["corr_gap"]]
                               + [_rel(got[k], want[k])
                                  for k in ("sp", "dd", "rdd")])
    return gaps
