"""Where one TEBD step of the MPS engine spends its time on the card.

    python tools/probe_mps_step.py

Needs one NVIDIA GPU with nvcc. On the shipped T=2.0 problem
(examples/InputFile_BHcontrolT2.0 with engine = mps: L=5, d=4, chi=25,
complex128, built as chip_smoke.py builds it) it times, with chip_smoke.py's
CUDA-event helper (mean of 10 runs after a warm-up):

* one `tebd.tebd_step` of a batch of B states, for B in 1, 4, 8, 16;
* the step's parts at the same B, one call each: the bond theta
  (`ops.bond_theta`, the CUDA kernel), the density matrix and its
  `torch.linalg.eigh` (125 x 125; also on the host's LAPACK, for
  comparison), and the gauge move's `torch.linalg.qr` (125 x 25);

and prints eigh's share of the step (4 bonds per step, so 4 x eigh / step).
Then `torch.profiler` over 5 steps at B=4 prints the ten largest ops by
device time, and the device time per step (the sum over device kernels)
beside the unprofiled step time: their ratio is the device's busy share.
"""

import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import cuda_ms, example_config  # noqa: E402
from optimalcontrolmps_torch import tebd  # noqa: E402
from optimalcontrolmps_torch.drivers import common  # noqa: E402
from optimalcontrolmps_torch.ops import bond_theta as bt  # noqa: E402
from optimalcontrolmps_torch.ops import trunc  # noqa: E402


def ms(fn):
    return cuda_ms(fn, 10)


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    p = common.build_problem(example_config(engine="mps"), engine="mps",
                             device="cuda")
    st = p.stepper
    u = torch.as_tensor(p.u0, device="cuda")
    print(f"L={p.L} p={st.p} chi={st.chi} {p.dtype} trunc={st.trunc_method}")
    for B in (1, 4, 8, 16):
        A = p.psi_i[None].expand(B, *p.psi_i.shape).contiguous()
        uf, ut = u[100].expand(B), u[101].expand(B)
        step = ms(lambda: tebd.tebd_step(st, A, uf, ut))
        Ai = A[:, 1].contiguous()
        Aj = A[:, 2].contiguous()
        theta_ms = ms(lambda: bt.bond_theta(Ai, Aj, st.gate_fwd))
        theta = bt.bond_theta(Ai, Aj, st.gate_fwd)
        rho = trunc._jitter(theta @ trunc._h(theta))
        rho_ms = ms(lambda: trunc._jitter(theta @ trunc._h(theta)))
        eigh_ms = ms(lambda: torch.linalg.eigh(rho))
        m = theta[..., :st.chi].contiguous()
        qr_ms = ms(lambda: torch.linalg.qr(m, mode="reduced"))
        rho_cpu = rho.cpu()
        torch.linalg.eigh(rho_cpu)
        t0 = time.perf_counter()
        for _ in range(10):
            torch.linalg.eigh(rho_cpu)
        cpu_eigh_ms = (time.perf_counter() - t0) / 10 * 1e3
        print(f"B={B:3d}: step {step:8.3f} ms; bond_theta {theta_ms:.4f} ms, "
              f"rho {rho_ms:.4f} ms, eigh {eigh_ms:.4f} ms (host LAPACK "
              f"{cpu_eigh_ms:.4f} ms), qr {qr_ms:.4f} ms; eigh share "
              f"{4 * eigh_ms / step:.1%}")

    B, steps = 4, 5
    A = p.psi_i[None].expand(B, *p.psi_i.shape).contiguous()
    uf, ut = u[100].expand(B), u[101].expand(B)
    step = ms(lambda: tebd.tebd_step(st, A, uf, ut))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(steps):
            tebd.tebd_step(st, A, uf, ut)
        torch.cuda.synchronize()
    avgs = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(avgs[0], "self_device_time_total")
            else "self_cuda_time_total")
    # device kernels only: the ops' rows repeat their kernels' time
    dev_ms = sum(getattr(e, attr) for e in avgs
                 if e.device_type == DeviceType.CUDA) / 1e3 / steps
    n_kernels = sum(e.count for e in avgs
                    if e.device_type == DeviceType.CUDA) / steps
    print(f"profiler, {steps} steps at B={B}: device time {dev_ms:.3f} ms "
          f"per step in {n_kernels:.0f} kernels, unprofiled step "
          f"{step:.3f} ms: device busy {dev_ms / step:.1%}")
    print(avgs.table(sort_by=attr, row_limit=10))


if __name__ == "__main__":
    main()
