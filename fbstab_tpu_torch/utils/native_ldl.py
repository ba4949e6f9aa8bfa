"""ctypes binding for the native sparse-LDL' kernel (counterpart of
`fbstab_tpu/utils/native_ldl.py`).

Builds the port's own copy of the C source, `fbstab_tpu_torch/native/
sparse_ldl.c`, with the host C compiler (the JAX package's flags, -O2
-shared -fPIC) into the git-ignored `fbstab_tpu_torch/_build/`, under a
name keyed by a hash of the source and the flags, as ops/_build.py keys
the CUDA library; a later process with the same source reuses it. The
build goes to a temporary name and is renamed into place, so processes
that build at once (xdist workers) never load a half-written file.
Nothing is built until `load()` is first called (a SparseLDL with the
native backend, i.e. a SparsePattern, is made), and a failed build raises:
unlike the JAX package, the port has no silent NumPy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "native" / "sparse_ldl.c"
BUILD_DIR = _PKG / "_build"
CC_FLAGS = ("-O2", "-shared", "-fPIC")
COMPILERS = ("cc", "gcc", "clang")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_I64 = ctypes.POINTER(ctypes.c_int64)
_F64 = ctypes.POINTER(ctypes.c_double)


def library_path() -> Path:
    """Where the shared object for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CC_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libsparse_ldl_{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    """Builds `out` with the first C compiler that succeeds; raises with
    every compiler's error when none does."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    errors = []
    for cc in COMPILERS:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([cc, *CC_FLAGS, "-o", tmp, str(SRC)], check=True,
                           capture_output=True, text=True, timeout=120)
            os.replace(tmp, out)
            return
        except (OSError, subprocess.SubprocessError) as e:
            errors.append(f"{cc}: {getattr(e, 'stderr', None) or e}")
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    raise RuntimeError(f"cannot build {SRC} with a C compiler: "
                       + "; ".join(errors))


def load() -> ctypes.CDLL:
    """The configured CDLL, building it on the first call. Raises
    RuntimeError when no C compiler builds the source."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _compile(path)
        lib = ctypes.CDLL(str(path))
        lib.fbstab_ldl_etree.restype = ctypes.c_int64
        lib.fbstab_ldl_etree.argtypes = [
            ctypes.c_int64, _I64, _I64, _I64, _I64, _I64]
        lib.fbstab_ldl_factor.restype = ctypes.c_int64
        lib.fbstab_ldl_factor.argtypes = [
            ctypes.c_int64, _I64, _I64, _F64, _I64, _I64, _I64, _F64,
            _F64, _F64, _F64, _I64, _I64, _I64]
        lib.fbstab_ldl_solve.restype = None
        lib.fbstab_ldl_solve.argtypes = [
            ctypes.c_int64, _I64, _I64, _F64, _F64, _F64]
        lib.fbstab_ldl_factor_solve_batch.restype = ctypes.c_int64
        lib.fbstab_ldl_factor_solve_batch.argtypes = [
            ctypes.c_int64, ctypes.c_int64, _I64, _I64, _F64, _I64, _I64,
            _I64, _F64, _F64, _F64, _F64, _I64, _I64, _I64, _F64,
            ctypes.c_int64]
        _lib = lib
        return _lib


def _ip(a: np.ndarray):
    return a.ctypes.data_as(_I64)


def _fp(a: np.ndarray):
    return a.ctypes.data_as(_F64)


def etree(n: int, Ap: np.ndarray, Ai: np.ndarray):
    """(parent, Lnz, nnz) for the upper-triangular CSC pattern, or raises
    ValueError on a malformed column (same contract as the NumPy path)."""
    lib = load()
    parent = np.empty(n, np.int64)
    Lnz = np.empty(n, np.int64)
    work = np.empty(n, np.int64)
    nnz = lib.fbstab_ldl_etree(
        n, _ip(Ap), _ip(Ai), _ip(parent), _ip(Lnz), _ip(work))
    if nnz < 0:
        raise ValueError(
            "Each column must be upper-triangular with an explicit "
            f"diagonal entry (column {-nnz - 1}).")
    return parent, Lnz, int(nnz)


class _Workspace:
    """Factor/solve scratch, allocated once per pattern and thread
    (allocation-free factor/solve calls)."""

    def __init__(self, n: int):
        self.Y = np.zeros(n, np.float64)
        self.pattern = np.empty(n, np.int64)
        self.flag = np.empty(n, np.int64)
        self.Lnz_cur = np.empty(n, np.int64)


def factor(n, Ap, Ai, Ax, parent, Lp, Li, Lx, D, Dinv, ws: _Workspace):
    """Numeric factorization into (Li, Lx, D, Dinv); raises
    ZeroDivisionError on a zero pivot (same contract as the NumPy path)."""
    lib = load()
    st = lib.fbstab_ldl_factor(
        n, _ip(Ap), _ip(Ai), _fp(Ax), _ip(parent), _ip(Lp), _ip(Li),
        _fp(Lx), _fp(D), _fp(Dinv), _fp(ws.Y), _ip(ws.pattern),
        _ip(ws.flag), _ip(ws.Lnz_cur))
    if st != 0:
        raise ZeroDivisionError(
            f"Zero pivot at column {st - 1}: matrix is not "
            "quasi-definite with this ordering.")


def solve(n, Lp, Li, Lx, Dinv, x):
    """In-place solve (L D L') x = b."""
    load().fbstab_ldl_solve(n, _ip(Lp), _ip(Li), _fp(Lx), _fp(Dinv), _fp(x))


def factor_solve_batch(n, Ap, Ai, AxB, parent, Lp, Li, Lx, D, Dinv,
                       ws: _Workspace, xB):
    """Factor+solve a batch sharing one pattern: AxB (batch, annz) values,
    xB (batch, n) rhs solved in place. Returns 0 or the 1-based column of
    the first zero pivot (that instance's rhs is left untouched)."""
    lib = load()
    batch, annz = AxB.shape
    return int(lib.fbstab_ldl_factor_solve_batch(
        batch, n, _ip(Ap), _ip(Ai), _fp(AxB), _ip(parent), _ip(Lp),
        _ip(Li), _fp(Lx), _fp(D), _fp(Dinv), _fp(ws.Y), _ip(ws.pattern),
        _ip(ws.flag), _ip(ws.Lnz_cur), _fp(xB), annz))
