"""Result files in the reference's column formats.

Counterpart of optimalcontrolmps_tpu/io.py (host numpy and json, copied so
the port imports nothing of the JAX package): the ramp, progress,
expectation, matrix and row-matrix text files, tab-separated like the
reference's, and the JSON checkpoint of the control vector and the
boundary-state cache, all in the JAX package's formats, so a checkpoint or
a state cache written by one package is read by the other.
"""

from __future__ import annotations

import json
import os

import numpy as np

__all__ = [
    "write_ramp_file", "read_ramp_file", "append_progress",
    "nprop_per_iteration", "write_expectation_file", "write_matrix",
    "read_matrix", "write_rowmat", "save_checkpoint", "load_checkpoint",
    "save_states", "load_states",
]


def _fmt(v):
    return f"{float(v):.10g}"


def write_ramp_file(path, times, u_init, fid_init, u_final, fid_final):
    """BHrampInitialFinal.txt: t, u_init, F_init, u_final, F_final per row."""
    with open(path, "w") as f:
        for row in zip(times, u_init, fid_init, u_final, fid_final):
            f.write("\t".join(_fmt(v) for v in row) + "\n")


def read_ramp_file(path):
    """The 5-column ramp file as a dict of numpy arrays."""
    data = np.loadtxt(path)
    if data.ndim == 1:
        data = data[None, :]
    return {"times": data[:, 0], "u_init": data[:, 1],
            "fid_init": data[:, 2], "u_final": data[:, 3],
            "fid_final": data[:, 4]}


def append_progress(path, iteration, objective, T, nprop):
    """ProgressCache.txt: iter, obj, T, Nprop appended per iteration."""
    with open(path, "a") as f:
        f.write(f"{iteration}\t{_fmt(objective)}\t{_fmt(T)}\t{nprop}\n")


def nprop_per_iteration(n_steps, ls_trials=0, exact_hessian=True):
    """The reference's propagation count: N(2 + ls_trials) [+ N(N-1)/2]."""
    n = n_steps * (2 + ls_trials)
    if exact_hessian:
        n += n_steps * (n_steps - 1) // 2
    return n


def write_expectation_file(path, times, expvals):
    """ExpectationN.txt: t then per-site <N> per row."""
    with open(path, "w") as f:
        for t, row in zip(times, expvals):
            f.write(_fmt(t) + "\t" + "\t".join(_fmt(v) for v in
                                               np.real(row)) + "\t\n")


def write_matrix(path, M):
    """GROUPHessian.txt / GRAPEHessian.txt: tab-separated rows."""
    with open(path, "w") as f:
        for row in np.asarray(M):
            f.write("\t".join(_fmt(v) for v in row) + "\t\n")


def read_matrix(path):
    return np.loadtxt(path)


def write_rowmat(path, rows):
    """The reference's saveRowmat format: one tab-separated row per line."""
    with open(path, "w") as f:
        for row in rows:
            f.write("\t".join(_fmt(v) for v in np.asarray(row)) + "\n")


def save_checkpoint(path, control, extra=None):
    """Atomic JSON checkpoint of the control vector and metadata."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"control": np.asarray(control).tolist(),
                   "extra": extra or {}}, f)
    os.replace(tmp, path)


def load_checkpoint(path):
    """(control as numpy, extra dict) of a save_checkpoint file."""
    with open(path) as f:
        payload = json.load(f)
    return np.asarray(payload["control"]), payload.get("extra", {})


def _meta_key(meta: dict):
    return json.loads(json.dumps(meta, sort_keys=True))


def save_states(path, psi_i, psi_f, meta: dict):
    """Atomic npz of the boundary states with a JSON fingerprint of the
    problem, `meta`, that load_states checks. A state is a plain MPS
    (L, chi, p, chi), a sector vector (ns,), numpy or a tensor on any
    device, or a Vidal state (anything with `B` and `lam`), saved as the
    `<name>_B` / `<name>_lam` pair."""
    def host(a):
        return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)

    arrays = {}
    for name, s in (("psi_i", psi_i), ("psi_f", psi_f)):
        if hasattr(s, "B") and hasattr(s, "lam"):
            arrays[name + "_B"], arrays[name + "_lam"] = host(s.B), host(
                s.lam)
        else:
            arrays[name] = host(s)
    tmp = path + ".tmp.npz"
    np.savez(tmp, __meta__=json.dumps(meta, sort_keys=True), **arrays)
    os.replace(tmp, path)


def load_states(path, meta: dict):
    """(psi_i, psi_f) from a save_states npz, each a numpy array or, for a
    Vidal state, a (B, lam) tuple of numpy arrays; None when the file is
    absent or its fingerprint differs from `meta`: a stale cache must never
    feed other physics."""
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        if json.loads(str(z["__meta__"])) != _meta_key(meta):
            return None
        return tuple(z[name] if name in z.files
                     else (z[name + "_B"], z[name + "_lam"])
                     for name in ("psi_i", "psi_f"))
