"""Build and load the hand-written CUDA kernels of the port.

The sources under `optimalcontrolmps_torch/csrc/` are compiled with nvcc for
Hopper (`sm_90a`) into a shared library with a plain C interface under
`optimalcontrolmps_torch/build/`, named after the hash of the source, and
loaded with ctypes. The first call builds; a changed source builds anew.
Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["load_sector_chain", "build_log"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "sector_chain.cu")
_BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}
# what the last build printed (ptxas register/shared-memory report) and took
build_log: dict = {}


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "optimalcontrolmps_torch need the CUDA toolkit")
    return found


def _build(src: str, out: str) -> None:
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_log.update(seconds=time.perf_counter() - t0,
                     ptxas=proc.stdout + proc.stderr, cmd=" ".join(cmd))


def load_sector_chain() -> ctypes.CDLL:
    """The sector-chain library, built at first use. The C entry points
    return cudaGetLastError() after their launch."""
    if "sector_chain" in _loaded:
        return _loaded["sector_chain"]
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    path = os.path.join(_BUILD, f"libsector_chain_{digest}.so")
    if not os.path.exists(path):
        _build(_SRC, path)
    lib = ctypes.CDLL(path)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sector_chain_fwd.argtypes = [P, P, P, P, P, P, P, P, I, I, F, F, P]
    lib.sector_chain_fwd.restype = I
    lib.sector_chain_bwd.argtypes = [P, P, P, P, P, P, P, P, P, I, I, F, F,
                                     P]
    lib.sector_chain_bwd.restype = I
    _loaded["sector_chain"] = lib
    return lib
