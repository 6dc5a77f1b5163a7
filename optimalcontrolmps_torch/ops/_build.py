"""Build and load the hand-written CUDA kernels and the host library.

Each `.cu` source under `optimalcontrolmps_torch/csrc/` is compiled with
nvcc for Hopper (`sm_90a`) into a shared library with a plain C interface
under `optimalcontrolmps_torch/build/`, named after the hash of the source,
and loaded with ctypes. The host library `csrc/ocmps_native.cpp` (sector
enumeration, the sector Hamiltonian's COO, seed ramps) is built the same way
with g++. The first call builds; a changed source builds anew; a failed
build raises. `build_all` starts one nvcc per CUDA source at once and waits
for all of them. Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["load_sector_chain", "load_bond_theta", "load_native",
           "build_all", "build_log", "SOURCES"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
# library name -> {C entry point: argtypes}; every entry returns an int
_ENTRIES = {
    "sector_chain": {
        "sector_chain_fwd": [_P] * 8 + [_I, _I, _F, _F, _P],
        "sector_chain_bwd": [_P] * 9 + [_I, _I, _F, _F, _P],
    },
    "bond_theta": {
        "bond_theta_c64": [_P] * 4 + [_I] * 3 + [_LL] * 2 + [_I] * 3 + [_P],
        "bond_theta_c128": [_P] * 4 + [_I] * 3 + [_LL] * 2 + [_I] * 3 + [_P],
    },
}
_U8, _I64, _D = (ctypes.POINTER(ctypes.c_uint8),
                 ctypes.POINTER(ctypes.c_int64),
                 ctypes.POINTER(ctypes.c_double))
# the host library: {C entry point: (restype, argtypes)}
_NATIVE = {
    "ocmps_sector_count": (ctypes.c_int64, [_I] * 3),
    "ocmps_sector_enumerate": (ctypes.c_int64, [_I] * 3 + [_U8, _LL]),
    "ocmps_sector_hamiltonian": (
        ctypes.c_int64, [_I] * 3 + [_U8, _LL, ctypes.c_double,
                                    ctypes.c_double, _I64, _I64, _D]),
    "ocmps_linsigmoid_batch": (None, [ctypes.c_double, ctypes.c_double, _I,
                                      _I, ctypes.c_uint64, _D]),
}
# -march=native as the JAX package's Makefile: its FMA contractions make
# linsigmoid_batch bitwise equal to that library's. The library's name
# hashes what the flag resolves to on the building host (`_host_target`),
# so a library built on one host is rebuilt, not loaded, on another.
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared"]
SOURCES = {name: os.path.join(_PKG, "csrc", f"{name}.cu")
           for name in _ENTRIES}
SOURCES["ocmps_native"] = os.path.join(_PKG, "csrc", "ocmps_native.cpp")

_loaded: dict = {}
# per library: what its build printed (ptxas register/shared-memory report),
# the command, and the seconds it took
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


@functools.lru_cache(maxsize=None)
def _host_target() -> str:
    """The target options that g++'s -march=native resolves to on this
    host (its cc1plus line): the CPU's identity for the library's name."""
    out = subprocess.run([_cxx(), "-march=native", "-E", "-v", "-x", "c++",
                          os.devnull, "-o", os.devnull],
                         capture_output=True, text=True, check=True)
    line = next(l for l in out.stderr.splitlines() if "cc1plus" in l)
    return " ".join(t for t in line.split()
                    if t.startswith(("-m", "--param")))


def _lib_path(name: str) -> str:
    """The library's path, named after the hash of its source and flags
    (and, for the host library, of this host's target)."""
    flags = " ".join(NVCC_FLAGS if name in _ENTRIES
                     else CXX_FLAGS + [_host_target()])
    with open(SOURCES[name], "rb") as fh:
        digest = hashlib.sha256(fh.read() + flags.encode()).hexdigest()[:16]
    return os.path.join(_BUILD, f"lib{name}_{digest}.so")


def _cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the host library of "
                           "optimalcontrolmps_torch needs a C++ compiler")
    return found


def _start(name: str):
    """Start nvcc (g++ for the host library) for one source; returns
    (name, out, tmp, cmd, t0, proc)."""
    os.makedirs(_BUILD, exist_ok=True)
    out = _lib_path(name)
    tmp = f"{out}.{os.getpid()}.tmp"
    if name in _ENTRIES:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCES[name]]
    else:
        cmd = [_cxx(), *CXX_FLAGS, "-o", tmp, SOURCES[name]]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, out, tmp, cmd, time.perf_counter(), proc


def _finish(job) -> None:
    name, out, tmp, cmd, t0, proc = job
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed "
                           f"({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{text}")
    os.replace(tmp, out)
    build_log[name] = {"seconds": time.perf_counter() - t0, "ptxas": text,
                       "cmd": " ".join(cmd)}


def build_all() -> None:
    """Build every CUDA library that is not built yet, one nvcc each, all
    started together."""
    jobs = [_start(name) for name in _ENTRIES
            if name not in _loaded and not os.path.exists(_lib_path(name))]
    errors = []
    for job in jobs:
        try:
            _finish(job)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))


def _load(name: str) -> ctypes.CDLL:
    if name in _loaded:
        return _loaded[name]
    path = _lib_path(name)
    if not os.path.exists(path):
        _finish(_start(name))
    lib = ctypes.CDLL(path)
    if name in _ENTRIES:
        for fn, argtypes in _ENTRIES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _I
    else:
        for fn, (restype, argtypes) in _NATIVE.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
    _loaded[name] = lib
    return lib


def load_sector_chain() -> ctypes.CDLL:
    """The sector-chain library, built at first use. The C entry points
    return cudaGetLastError() after their launch."""
    return _load("sector_chain")


def load_bond_theta() -> ctypes.CDLL:
    """The bond-theta library, built at first use. The C entry points
    return cudaGetLastError() after their launch, or a CUDA error code for
    a tile plan that the kernel does not take."""
    return _load("bond_theta")


def load_native() -> ctypes.CDLL:
    """The host library (csrc/ocmps_native.cpp), built with g++ at first
    use."""
    return _load("ocmps_native")
