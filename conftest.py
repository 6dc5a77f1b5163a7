"""One thread budget for every test process, set before numpy, jax and
torch load (pytest loads this file before tests/conftest.py, which imports
jax).

The tier-1 command runs 6 pytest-xdist workers on an 8-core host. Without
a cap each worker ran OpenBLAS (numpy's, and the LAPACK behind JAX's CPU
eigh/QR), MKL and torch's OpenMP pool at the host's full width: six
workers held ~60 threads each, the load average stood at 20-40, and the
command did not reach its end in 1470 s. Six cold copies of
test_cost_golden.py at once, a file that takes 22 s alone, did not finish
in 150 s; with OMP_NUM_THREADS=1 all six finished in 22-25 s. XLA's own
CPU thread caps (--xla_cpu_multi_thread_eigen=false) did not help, alone
or beside it, and two threads a process made tier-1 slower. So every test
process gets THREADS = 1 (torch takes its intra-op threads from
OMP_NUM_THREADS when it loads); with it tier-1 takes 160-192 s from a
cold .jax_cache. A caller's own OMP_NUM_THREADS is kept. Spawned ranks
set their own (`run_world(threads=)`).
"""

import os

THREADS = 1
os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
