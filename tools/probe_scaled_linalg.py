"""The dense factorizations of the reference-scale Vidal and DMRG paths,
alone, on the card.

    python tools/probe_scaled_linalg.py [--real]

Needs one NVIDIA GPU. At N=20, d=7 (p=8), chi=128 the Vidal stage's density
matrices are (10, 1024, 1024) and (9, 1024, 1024), and a DMRG bond's split
is the SVD of one (1024, 1024) theta, both complex64. On matrices built
from a numpy seed with the spectra these paths see, it prints for each
route whether it succeeded, its time (CUDA events, mean of 3 after a
warm-up; a failed route is timed to its error) and its error against a
float64 reference:

* `torch.linalg.eigh` of jittered density matrices m^H m whose m has rank
  8 (a chain-end bond: only the left index 0 is occupied), the same with
  the exactly zero blocks of a padded state (the right bond of rank 64),
  or a Schmidt spectrum decaying as exp(-k/12): in complex64, and in
  complex128 with the result cast back;
* `torch.linalg.svd` of a theta with singular values exp(-k/20), each
  cuSOLVER driver (None, gesvd, gesvdj, gesvda) in complex64 and the
  default in complex128, and the CPU's LAPACK;
* one two-site H_eff matvec and one 25-step Lanczos solve at chi=128 with
  random environments;
* on a real state (`--real`, or `--real128` for a complex128 DMRG): the
  DMRG ground state of the reference config (N=20, Npart=20, d=7, U=2.5,
  chi=128, complex64; the ramp, then REAL_SWEEPS sweeps at chi=128), each
  sweep's time and energy, its Vidal form (complex64), and for every bond
  of the first Vidal stage its density matrix's eigh in complex64 and in
  complex128 (ok or failed, finiteness, scale), then one vidal_step.
"""

import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import cuda_ms  # noqa: E402
from optimalcontrolmps_torch import dmrg, tebd, vidal  # noqa: E402
from optimalcontrolmps_torch.ops.bond_theta import bond_theta  # noqa: E402
from optimalcontrolmps_torch.ops.trunc import _jitter  # noqa: E402

CHI, P = 128, 8
N = CHI * P
REAL_SWEEPS = 6


def cplx(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def with_spectrum(rng, s):
    """(N, N) complex matrix U diag(s) V^H, U and V Haar-like."""
    u, _ = np.linalg.qr(cplx(rng, N, N))
    v, _ = np.linalg.qr(cplx(rng, N, N))
    return (u * s[None, :]) @ v.conj().T


def attempt(label, fn, reps=3):
    """(ok, ms, result) of fn on the card; a LinAlgError is a failure."""
    try:
        out = fn()
        torch.cuda.synchronize()
        ms = cuda_ms(fn, reps)
        return True, ms, out
    except torch.linalg.LinAlgError as exc:
        print(f"  {label}: FAILED: {str(exc).splitlines()[0]}")
        return False, None, None


def probe_eigh(rng):
    k = np.arange(N)
    rows = np.arange(N)[:, None] < P
    # a chain-end bond of a padded state: left index 0 only, and the right
    # site's bond of rank 64 < chi, so whole blocks of theta are exactly 0
    cols = (np.arange(N) % CHI)[None, :] < 64
    ms = {
        "rank 8 (chain end)": np.stack([np.where(rows, cplx(rng, N, N), 0.0)
                                        for _ in range(2)]),
        "rank 8, padded (chain end, exact zero blocks)": np.stack([np.where(
            rows & cols, cplx(rng, N, N), 0.0) for _ in range(2)]),
        "exp(-k/12) spectrum": np.stack([with_spectrum(
            rng, np.exp(-k / 12.0)) for _ in range(2)]),
    }
    for name, m_np in ms.items():
        m = torch.as_tensor(m_np, dtype=torch.complex64, device="cuda")
        rho = _jitter(m.conj().transpose(-2, -1) @ m)
        ref = torch.linalg.eigvalsh(rho.to(torch.complex128))
        for label, fn in (
                ("eigh complex64", lambda: torch.linalg.eigh(rho)),
                ("eigh complex128, cast back", lambda: tuple(
                    x.to(y) for x, y in zip(
                        torch.linalg.eigh(rho.to(torch.complex128)),
                        (torch.float32, torch.complex64))))):
            ok, t, out = attempt(f"{name}: {label}", fn)
            if ok:
                w = out[0].double()
                err = float((w - ref).abs().max() / ref.abs().max())
                top = float((w[:, -CHI:] - ref[:, -CHI:]).abs().max()
                            / ref.abs().max())
                print(f"  {name}: {label}: {t:.2f} ms for 2, eigenvalue "
                      f"err {err:.2e} (top {CHI}: {top:.2e}) of max")


def probe_svd(rng):
    s = np.exp(-np.arange(N) / 20.0)
    th64 = torch.as_tensor(with_spectrum(rng, s)[None], device="cuda")
    th = th64.to(torch.complex64)
    ref = torch.linalg.svdvals(th64)
    for label, x, drv in (("complex64 default", th, None),
                          ("complex64 gesvd", th, "gesvd"),
                          ("complex64 gesvdj", th, "gesvdj"),
                          ("complex64 gesvda", th, "gesvda"),
                          ("complex128 default", th64, None)):
        ok, t, out = attempt(label, lambda: torch.linalg.svd(
            x, full_matrices=False, driver=drv))
        if ok:
            u, sv, vh = out
            err = float((sv.double()[..., :CHI] - ref[..., :CHI]).abs().max())
            rec = float(torch.linalg.matrix_norm(
                (u[..., :CHI] * sv[..., None, :CHI].to(u.dtype))
                @ vh[..., :CHI, :] - x).max())
            print(f"  svd {label}: {t:.2f} ms, top-{CHI} singular values "
                  f"err {err:.2e}, rank-{CHI} residual {rec:.3e} "
                  f"(exact {float(np.sqrt(np.sum(s[CHI:] ** 2))):.3e})")
    host = th.cpu()
    t0 = time.perf_counter()
    for _ in range(3):
        torch.linalg.svd(host, full_matrices=False)
    print(f"  svd complex64 on the CPU ({torch.get_num_threads()} threads): "
          f"{(time.perf_counter() - t0) / 3 * 1e3:.2f} ms")


def probe_lanczos(rng):
    W = torch.as_tensor(dmrg.bh_mpo(20, 7, 1.0, 2.5, dtype=np.complex64,
                                    npart=20, number_penalty=2.0),
                        device="cuda")
    Lenv, Renv = (torch.as_tensor(cplx(rng, 5, CHI, CHI),
                                  dtype=torch.complex64, device="cuda")
                  for _ in range(2))
    Lenv = Lenv + Lenv.conj().transpose(-2, -1)
    Renv = Renv + Renv.conj().transpose(-2, -1)
    theta = torch.as_tensor(cplx(rng, CHI, P, P, CHI),
                            dtype=torch.complex64, device="cuda")
    mv_ms = cuda_ms(lambda: dmrg._heff_matvec(Lenv, W, Renv, theta), 10)
    lz_ms = cuda_ms(lambda: dmrg._lanczos_ground(
        lambda x: dmrg._heff_matvec(Lenv, W, Renv, x), theta), 3)
    print(f"  H_eff matvec at chi={CHI}: {mv_ms:.3f} ms; Lanczos (25): "
          f"{lz_ms:.2f} ms")


def probe_real():
    real_sweep = dmrg._sweep
    times = []

    def timed_sweep(A, W, chi, krylov):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_sweep(A, W, chi, krylov)
        torch.cuda.synchronize()
        times.append((chi, round(time.perf_counter() - t0, 3), out[1]))
        return out

    dmrg._sweep = timed_sweep
    t0 = time.perf_counter()
    dtype = (torch.complex128 if "--real128" in sys.argv[1:]
             else torch.complex64)
    A, e = dmrg.dmrg_ground_state(20, 7, 20, 1.0, 2.5, chi=CHI,
                                  n_sweeps=REAL_SWEEPS, dtype=dtype,
                                  e_tol=0.0)
    A = A.to(torch.complex64)
    dmrg._sweep = real_sweep
    print(f"  DMRG {time.perf_counter() - t0:.1f} s, E = {e!r}; sweeps "
          f"(chi, s, E): {times}")
    state = vidal.from_mps(A)
    lam = state.lam.double().cpu().numpy()
    print(f"  Vidal form: |B| max {float(state.B.abs().max()):.3e}; Schmidt "
          f"values > 1e-12 per bond {(lam > 1e-12).sum(1).tolist()}; "
          f"smallest kept {[float(x[x > 1e-12].min()) for x in lam]}")
    st = tebd.make_stepper(20, 7, 1.0, 0.02, CHI, dtype=torch.complex64,
                           sweep="vidal")
    bonds = list(range(0, 19, 2))
    T = state.B
    th = bond_theta(torch.stack([T[b] for b in bonds]),
                    torch.stack([T[b + 1] for b in bonds]), st.gate_fwd)
    ones = torch.ones_like(state.lam[0])
    Ll = torch.stack([state.lam[b - 1] if b > 0 else ones for b in bonds])
    m = (th.reshape(len(bonds), CHI, P, P * CHI)
         * Ll.to(th.dtype)[:, :, None, None]).reshape(len(bonds), N, N)
    rho = _jitter(m.conj().transpose(-2, -1) @ m)
    for k, b in enumerate(bonds):
        r = rho[k]
        ok = {}
        for name, x in (("c64", r), ("c128", r.to(torch.complex128))):
            try:
                torch.linalg.eigh(x)
                ok[name] = "ok"
            except torch.linalg.LinAlgError:
                ok[name] = "FAILED"
        print(f"  stage bond {b}: finite {bool(torch.isfinite(r).all())}, "
              f"|th| max {float(th[k].abs().max()):.3e}, trace "
              f"{float(torch.diagonal(r).real.sum()):.3e}, eigh {ok}")
    u = torch.full((1,), 2.5, device="cuda")
    try:
        vidal.vidal_step(st, vidal.VidalState(state.B[None], state.lam[None]),
                         u, u)
        print("  vidal_step: ok")
    except torch.linalg.LinAlgError as exc:
        print(f"  vidal_step: FAILED: {str(exc).splitlines()[0]}")


def main():
    if not torch.cuda.is_available():
        sys.exit("probe_scaled_linalg: needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), torch.__version__,
          torch.version.cuda, flush=True)
    rng = np.random.default_rng(0)
    print("eigh of the Vidal stage's density matrices (2 of 1024 x 1024):")
    probe_eigh(rng)
    print("SVD of a DMRG two-site theta (1024 x 1024):")
    probe_svd(rng)
    print("DMRG Lanczos:")
    probe_lanczos(rng)
    if {"--real", "--real128"} & set(sys.argv[1:]):
        print("a real reference-scale state:")
        probe_real()


if __name__ == "__main__":
    main()
