"""Shared driver setup: config -> physics problem.

Counterpart of optimalcontrolmps_tpu/drivers/common.py (the common preamble
of the reference's executables): parse the InputFile, build the seed ramp,
basis, boundary ground states and stepper. J = 1, U_i = 2.5 and U_f = 50
are fixed as in the reference.

Device: the run is on the card unless the config asks for the CPU with
`backend = cpu` (or the caller passes `device`). `precision = double`
(the default) runs complex128 on either; the JAX package's redirect of
double precision to the CPU was a TPU workaround.

State cache: `build_problem(state_cache=path)` loads the boundary ground
states from an npz when its problem fingerprint matches, else computes and
saves them (the JAX package's format and fingerprint).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import control as controllib
from .. import groundstate, sector, seeds, tebd, vidal
from .. import io as iolib
from ..backends import engine_for, sector_fits
from ..config import InputGroup, parse_input_file
from ..device import resolve_device
from ..mps import expectation_values
from ..sites import op
from ..streaming import rollout_measure

__all__ = ["AnalysisSetup", "ProblemSetup", "analysis_setup",
           "build_problem", "config_device", "default_dtype",
           "effective_chi", "exp_ramp", "populations", "print_banner",
           "quench_ramp", "time_axis"]

J_HOP = 1.0
U_INITIAL = 2.5
U_FINAL = 50.0


@dataclasses.dataclass
class ProblemSetup:
    cfg: InputGroup
    L: int
    npart: int
    d: int
    T: float
    tstep: float
    n_steps: int
    M: int
    gamma: float
    chi: int
    threshold: float
    stepper: object
    psi_i: torch.Tensor
    psi_f: torch.Tensor
    basis: controllib.ControlBasis
    u0: np.ndarray
    seed: int
    dtype: torch.dtype
    device: torch.device
    kind: str = "mps"   # "mps" (snake TEBD), "vidal" (canonical-form
    #                     brick TEBD) or "sector" (fixed-N dense)


def config_device(cfg: InputGroup) -> torch.device:
    """The config's `backend` key: "cpu" asks for the CPU, "cuda"/"gpu"
    (or no key) for the card, which must exist."""
    backend = cfg.get_string("backend", "").strip().lower()
    if backend == "cpu":
        return torch.device("cpu")
    if backend in ("", "cuda", "gpu"):
        return resolve_device(None)
    raise ValueError(f"backend {backend!r}: the port runs on 'cuda' (the "
                     f"default) or 'cpu'")


def default_dtype(device) -> torch.dtype:
    """The analysis drivers' dtype when the caller names none: complex128
    on the CPU, complex64 on the card (the JAX package's rule for its CPU
    and accelerator backends)."""
    return (torch.complex128 if torch.device(device).type == "cpu"
            else torch.complex64)


@dataclasses.dataclass
class AnalysisSetup:
    """The chain, time grid, device and dtypes of an analysis driver."""
    cfg: InputGroup | None
    tstep: float
    T: float
    L: int
    npart: int
    d: int
    device: torch.device
    dtype: torch.dtype
    real: torch.dtype          # the controls' dtype
    np_complex: type           # the host states' dtype


def analysis_setup(cfg_path, device, dtype, T: float) -> AnalysisSetup:
    """Parse the InputFile of analyze_quench or analyze_bond_dim (tstep,
    T, N, Npart, d with the reference's config defaults; device None: the
    config's backend), or, without one, the reference's long chain N=20,
    Npart=20, d=7, tstep 5e-3 at time T on the card. dtype None: the
    device's `default_dtype`."""
    cfg = None
    if cfg_path is not None:
        cfg = parse_input_file(cfg_path)
        tstep, T = cfg.get_real("tstep", 1e-2), cfg.get_real("T", 6)
        L, npart = cfg.get_int("N", 8), cfg.get_int("Npart", 8)
        d = cfg.get_int("d", 8)
        device = config_device(cfg) if device is None else device
    else:
        tstep, L, npart, d = 5e-3, 20, 20, 7
    device = resolve_device(device)
    dtype = default_dtype(device) if dtype is None else dtype
    double = dtype == torch.complex128
    return AnalysisSetup(cfg, tstep, T, L, npart, d, device, dtype,
                         torch.float64 if double else torch.float32,
                         np.complex128 if double else np.complex64)


def effective_chi(max_bond_dim: int, L: int, p: int) -> int:
    """The requested maxBondDim capped at p**(L//2), beyond which padding
    is waste."""
    return int(min(max_bond_dim, p ** (L // 2)))


def build_problem(cfg: InputGroup, seed: int = 1, dtype=None, u0=None,
                  engine: str = "mps", device=None,
                  state_cache: str = None) -> ProblemSetup:
    """engine: "mps" (the reference's snake TEBD), "vidal" (canonical-form
    brick TEBD with truncation, the long-chain path), "sector" (fixed-N
    dense engine) or "auto" (sector when it fits and the MPS path would be
    truncation-free, else mps; never vidal). Boundary states come from
    `groundstate.initialize_state` (DMRG above its exact-diagonalization
    limit), in the Vidal form for engine = vidal. device=None: the
    config's `backend`.
    state_cache: optional npz path of the boundary states, loaded when its
    fingerprint matches this problem, else written after they are made."""
    device = config_device(cfg) if device is None else torch.device(device)
    tstep = cfg.get_real("tstep", 1e-2)
    T = cfg.get_real("T")
    L = cfg.get_int("N")
    npart = cfg.get_int("Npart")
    d = cfg.get_int("d")
    M = cfg.get_int("M", 1)
    gamma = cfg.get_real("gamma", 0.0)
    max_bond = cfg.get_int("maxBondDim", 100)
    threshold = cfg.get_real("threshold", 1e-7)
    if dtype is None:
        dtype = (torch.complex128
                 if cfg.get_string("precision", "double") == "double"
                 else torch.complex64)
    real = torch.float64 if dtype == torch.complex128 else torch.float32

    n_steps = int(T / tstep + 1)
    chi = effective_chi(max_bond, L, d + 1)

    # the reference seeds srand(123456789*seed) before linsigmoidSeed
    rng = np.random.default_rng(123456789 * seed)
    if u0 is None:
        u0 = seeds.linsigmoid_seed(U_INITIAL, U_FINAL, n_steps, rng=rng)
    basis = controllib.chopped_sine_basis(u0, tstep, T, M, dtype=real,
                                          device=device)
    bound = tebd.exact_rank_bound(L, d + 1)
    if engine == "auto":
        engine = ("sector" if sector_fits(L, d, npart) and chi >= bound
                  else "mps")
    elif engine == "sector" and chi < bound:
        print(f"NOTE: engine=sector is exact (chi = sector dim); "
              f"maxBondDim={max_bond} (effective chi={chi}) is superseded "
              f"and no truncation occurs.")
    trunc = cfg.get_string("truncMethod", "eigh")
    state_meta = {"L": L, "d": d, "npart": npart, "chi": chi,
                  "engine": engine, "trunc": trunc,
                  "u_ends": [float(u0[0]), float(u0[-1])],
                  "dtype": str(dtype).removeprefix("torch.")}
    cached = (iolib.load_states(state_cache, state_meta)
              if state_cache else None)
    if engine == "sector":
        stepper = sector.make_sector_stepper(L, d, npart, J_HOP, tstep,
                                             dtype=dtype, device=device)

        def ground(u):
            return sector.sector_ground_state(L, d, npart, J_HOP, u,
                                              dtype=dtype, device=device)
    elif engine in ("mps", "vidal"):
        stepper = tebd.make_stepper(L, d, J_HOP, tstep, chi, dtype=dtype,
                                    device=device, trunc_method=trunc,
                                    sweep="vidal" if engine == "vidal"
                                    else "snake")

        def ground(u):
            A = groundstate.initialize_state(L, d, npart, J_HOP, u, chi,
                                             dtype=dtype, device=device)
            return (vidal.from_mps(A, device=device) if engine == "vidal"
                    else A)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    if cached is not None:
        psi_i, psi_f = (
            vidal.VidalState(*(torch.as_tensor(a, device=device)
                               for a in s)) if isinstance(s, tuple)
            else torch.as_tensor(s, dtype=dtype, device=device)
            for s in cached)
    else:
        psi_i, psi_f = ground(float(u0[0])), ground(float(u0[-1]))
        if state_cache:
            iolib.save_states(state_cache, psi_i, psi_f, state_meta)
    return ProblemSetup(cfg=cfg, L=L, npart=npart, d=d, T=T, tstep=tstep,
                        n_steps=n_steps, M=M, gamma=gamma, chi=chi,
                        threshold=threshold, stepper=stepper, psi_i=psi_i,
                        psi_f=psi_f, basis=basis, u0=np.asarray(u0),
                        seed=seed, dtype=dtype, device=device, kind=engine)


def print_banner(p: ProblemSetup, extra=None):
    """The reference's parameter banner."""
    print("Performing optimal control of Bose-Hubbard model ... \n")
    print(" ******* Parameters used ******* ")
    rows = [
        ("Number of sites", p.L), ("Number of particles", p.npart),
        ("Local Fock space dimension", p.d), ("Control duration", p.T),
        ("Time-step size", p.tstep), ("GROUP dimension", p.M),
        ("Gamma (regularisation)", p.gamma),
        ("Bond dimension (static chi)", p.chi),
        ("Seed", p.seed), ("Device", p.device),
    ]
    for k, v in (rows + (list(extra.items()) if extra else [])):
        print(f"{k:.<33} {v}")
    print()


def time_axis(p: ProblemSetup) -> np.ndarray:
    return np.arange(p.n_steps) * p.tstep


def exp_ramp(u_i: float, u_f: float, length: int) -> np.ndarray:
    """The reference's expRamp: u_i exp(b i), b = log(u_f / u_i) / length."""
    b = np.log(u_f / u_i) / length
    return u_i * np.exp(b * np.arange(length))


def quench_ramp(u_i: float, u_f: float, length: int) -> np.ndarray:
    """The reference's quenchRamp: u_f at every time but the first."""
    r = np.full(length, u_f)
    r[0] = u_i
    return r


def populations(p: ProblemSetup, u: torch.Tensor) -> torch.Tensor:
    """(N_t, L) <n_i>(t) of psi_i propagated under u (N_t,) by the
    problem's engine: one state in flight on the MPS and Vidal engines,
    the (N_t, ns) trajectory on the sector engine (its states are small)."""
    st, psi_i = p.stepper, p.psi_i
    if p.kind == "sector":
        return sector.expectation_n(st, engine_for(st).rollout(st, psi_i, u))
    n_op = op("N", p.d)
    if p.kind == "vidal":
        return rollout_measure(
            lambda s, ua, ub: vidal.vidal_step(st, s, ua, ub, forward=True),
            vidal.VidalState(psi_i.B[None], psi_i.lam[None]), u,
            lambda s: expectation_values(s.B, n_op).real[0])
    return rollout_measure(
        lambda s, ua, ub: tebd.tebd_step(st, s, ua, ub, forward=True),
        psi_i[None], u, lambda s: expectation_values(s, n_op).real[0])
