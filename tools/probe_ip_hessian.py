"""Time one exact MPS Hessian on the card, dense and streaming, and eigh's
share of it.

    python tools/probe_ip_hessian.py [T] [row_block]

Needs one NVIDIA GPU with nvcc. The problem is chip_smoke.py's `ip_mps`
one: examples/InputFile_BHcontrolT2.0 with engine = mps (L=5, d=4, chi=25,
complex128) at T (default 0.5, N_t = 51), the control at c = 0. Prints, as
one JSON line:

* `engine.hessian` (dense: every row state in one batch) and
  `engine.hessian_streaming` (streaming.BlockHessian, rows in blocks of
  `row_block`, default 16, rounded down to a divisor of N_t - 1), each
  timed twice on the host clock with a device sync at the end, from the
  gradient's aux (the interior point reuses it); and max |H_dense -
  H_streaming|;
* for each, a third run with `torch.linalg.eigh` wrapped to sync and
  time every call: the time inside eigh over that run's wall (the syncs
  add a little to both);
* the bond-theta launches of one Hessian, and the card's name and power
  limit;
* batch invariance of the row step: the dense Hessian steps its rows in
  batches of up to N_t - 2, the streaming one in blocks of row_block, so
  the same row state is stepped once in a batch of 48 and once in a batch
  of 10 (its first rows), and once alone: max |difference| of the stepped
  rows' site tensors (a gauge-dependent reading) and of their dense state
  vectors (the physical one); and the same 48-against-10 difference for
  the step's parts on the rows' first bond: the bond theta (the kernel),
  the eigenvalues of its density matrix (eigh), QR, and a per-state norm.
"""

import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import example_config  # noqa: E402
from optimalcontrolmps_torch import engine, tebd  # noqa: E402
from optimalcontrolmps_torch import mps as mpslib  # noqa: E402
from optimalcontrolmps_torch.drivers import common  # noqa: E402
from optimalcontrolmps_torch.ops import bond_theta as bt  # noqa: E402
from optimalcontrolmps_torch.precision import (  # noqa: E402
    enforce_matmul_precision)
from optimalcontrolmps_torch.streaming import pick_row_block  # noqa: E402


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def with_eigh_timer(fn):
    """(wall s, seconds inside torch.linalg.eigh, eigh calls) of fn()."""
    real = torch.linalg.eigh
    spent = [0.0, 0]

    def eigh(a, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(a, *args, **kw)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
        return out

    torch.linalg.eigh = eigh
    try:
        _, wall = timed(fn)
    finally:
        torch.linalg.eigh = real
    return wall, spent[0], spent[1]


def main():
    T = float(sys.argv[1]) if len(sys.argv) > 1 else 0.5
    row_block = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    enforce_matmul_precision()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    p = common.build_problem(example_config(engine="mps", T=T),
                             engine="mps", device="cuda")
    st, gamma = p.stepper, p.gamma
    u = p.basis.convert_control(torch.zeros(p.M, dtype=torch.float64,
                                            device="cuda"))
    _, aux = engine.gradient(st, p.psi_i, p.psi_f, u, gamma)
    _, aux_s = engine.gradient_segmented(st, p.psi_i, p.psi_f, u, gamma)

    def dense():
        return engine.hessian(st, p.psi_i, p.psi_f, u, gamma, aux=aux)

    def streaming():
        return engine.hessian_streaming(st, p.psi_i, p.psi_f, u, gamma,
                                        aux=aux_s, row_block=row_block)

    out = {"device": smi, "T": T, "n_steps": p.n_steps,
           "row_block": pick_row_block(p.n_steps - 1, row_block)}
    H = {}
    for name, fn in (("dense", dense), ("streaming", streaming)):
        bt.reset_counts()
        H[name], t1 = timed(fn)
        launches = bt.bond_theta_launches
        _, t2 = timed(fn)
        wall, in_eigh, calls = with_eigh_timer(fn)
        out[name] = {"s": [t1, t2], "bond_theta_launches": launches,
                     "eigh_calls": calls, "eigh_s": in_eigh,
                     "wall_with_eigh_syncs_s": wall,
                     "eigh_share": in_eigh / wall}
    out["max_abs_diff"] = float((H["dense"] - H["streaming"]).abs().max())
    out["max_abs_H"] = float(H["dense"].abs().max())

    # the rows of the Hessian at t_1..t_48, stepped t_24 -> t_25 in three
    # batchings
    half = 0.5 * st.nn1
    rows, _ = mpslib.apply_site_sum_diag(aux[0][1:49], half,
                                         method=st.trunc_method)

    def step(A):
        return tebd.tebd_step(st, A, u[24], u[25], forward=True)

    s48, s10 = step(rows), step(rows[:10].clone())
    s1 = step(rows[:1].clone())
    out["row_step_batch_48_vs_10"] = float((s48[:10] - s10).abs().max())
    out["row_step_batch_48_vs_1"] = float((s48[:1] - s1).abs().max())
    v48, v10, v1 = (mpslib.to_statevector(a) for a in (s48[:10], s10, s1))
    out["row_step_statevector_48_vs_10"] = float((v48 - v10).abs().max())
    out["row_step_statevector_48_vs_1"] = float((v48[:1] - v1).abs().max())

    def parts(A):
        B, chi, p_ = A.shape[0], st.chi, st.p
        theta = bt.bond_theta(A[:, 0].contiguous(), A[:, 1].contiguous(),
                              st.gate_fwd)
        rho = theta @ theta.mH
        return {"bond_theta": theta, "eigh": torch.linalg.eigh(rho)[0],
                "qr": torch.linalg.qr(A[:, 1].reshape(B, chi * p_, chi))[0],
                "norm": torch.linalg.vector_norm(A[:, 1], dim=(1, 2, 3))}

    p48, p10 = parts(rows), parts(rows[:10].clone())
    out["parts_48_vs_10"] = {k: float((p48[k][:10] - p10[k]).abs().max())
                             for k in p48}
    print(json.dumps({"ip_hessian": out}))


if __name__ == "__main__":
    main()
