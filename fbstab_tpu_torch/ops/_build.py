"""Builds the CUDA kernels at first use and loads them with ctypes.

`load_library()` compiles every `csrc/*.cu` with nvcc, one process per
source, all started together, and links the objects into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), under `fbstab_tpu_torch/_build/`, keyed by a hash of the sources
and flags; a later call with the same sources reuses it. Nothing is built
or looked up until a CUDA tensor reaches a kernel, and a failed build
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

from fbstab_tpu_torch import telemetry

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")
LINK_FLAGS = ARCH_FLAGS + ("-shared",)


class SolveOpts(ctypes.Structure):
    """Mirror of `struct SolveOpts` in csrc/fbstab_solve.cuh (field order
    and types must match)."""

    _fields_ = [(n, ctypes.c_float) for n in (
        "sigma", "alpha", "om_alpha", "beta", "eta", "delta",
        "abs_tol", "rel_tol", "stall_tol", "infeas_tol",
        "inner_tol_max", "inner_tol_min", "inner_stall_tol", "om_stall")] + [
        (n, ctypes.c_int) for n in (
            "max_newton", "max_prox", "max_inner", "max_ls",
            "check_feasibility", "nonmonotone")]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")), sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libfbstab_{h.hexdigest()[:16]}.so"


def ptxas_lines(source: str, log: str | None = None,
                entry: str | None = None) -> list:
    """The register and spill lines ptxas printed for one source of csrc/
    (e.g. "mpc_solve.cu") in a build log, by default the current
    library's; with `entry`, only for the kernels whose (mangled) names
    contain it (e.g. "stage_matvec_teamILi18ELb1E", form 0 at n = 18)."""
    if log is None:
        log = library_path().with_suffix(".log").read_text()
    part = log.split(f"== {source}")[-1].split("==")[0]
    if entry is not None:
        part = "".join(f for f in part.split("Compiling entry function")
                       if entry in f.split("\n")[0])
    return [ln.strip() for ln in part.splitlines()
            if "registers" in ln or "spill" in ln]


def _cuobjdump() -> str | None:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/cuobjdump")
    return str(cand) if cand.exists() else None


def sass_blocks(lib_path, kernel: str) -> list | None:
    """The SASS (cuobjdump -sass) of the kernels inside the shared library
    at `lib_path` whose (mangled) names contain `kernel`, one text block
    each; None where cuobjdump is missing."""
    tool = _cuobjdump()
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    blocks = re.split(r"\n\s*Function : ", sass)
    mine = [blk for blk in blocks[1:] if kernel in blk.split("\n", 1)[0]]
    if not mine:
        raise RuntimeError(f"no SASS for {kernel} in {lib_path}")
    return mine


def _compile(out: Path) -> None:
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        nvcc = _nvcc()
        objs = [tmp / (p.stem + ".o") for p in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o),
                                   str(p)], stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for p, o in zip(cu, objs)]
        logs, failed = [], []
        for p, proc in zip(cu, procs):
            so, se = proc.communicate()
            logs.append(f"== {p.name}\n{se}{so}")
            if proc.returncode != 0:
                failed.append(f"{p.name} ({proc.returncode})")
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                               + "".join(logs))
        lib = tmp / "lib.so"
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(lib),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr}{link.stdout}")
        out.with_suffix(".log").write_text("".join(logs) + link.stderr
                                           + link.stdout)
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # K1, K2 and K4 take (N, nx, nu, nc[, B], lowmem, ...).
    for fn in (lib.fb_riccati_ws_floats, lib.fb_solve_ws_floats,
               lib.fb_subproblem_ws_floats):
        fn.argtypes = [I] * 5
        fn.restype = ctypes.c_longlong
    lib.fb_riccati_step.argtypes = [I] * 6 + [F, F] + [P] * 17 + [P]
    lib.fb_riccati_step.restype = I
    for fn in (lib.fb_solve_smem_bytes, lib.fb_subproblem_smem_bytes):
        fn.argtypes = [I, I, I, I]
        fn.restype = ctypes.c_longlong
    lib.fb_mpc_solve.argtypes = [I] * 6 + [SolveOpts] + [P] * 25 + [P]
    lib.fb_mpc_solve.restype = I
    lib.fb_dense_ws_floats.argtypes = [I, I, I]
    lib.fb_dense_ws_floats.restype = ctypes.c_longlong
    lib.fb_dense_solve.argtypes = [I, I, I, I, SolveOpts] + [P] * 19 + [P]
    lib.fb_dense_solve.restype = I
    lib.fb_mpc_subproblem.argtypes = [I] * 6 + [SolveOpts] + [P] * 32 + [P]
    lib.fb_mpc_subproblem.restype = I
    for fn in (lib.fb_mpc_solve_info, lib.fb_mpc_subproblem_info,
               lib.fb_riccati_info):
        fn.argtypes = [I] * 5 + [P]
        fn.restype = I
    lib.fb_combine_info.argtypes = [I, P]
    lib.fb_combine_info.restype = I
    lib.fb_assoc_combine.argtypes = [I, I, I] + [P] * 16 + [P]
    lib.fb_assoc_combine.restype = I
    lib.fb_dense_solve_info.argtypes = [I, I, I, P]
    lib.fb_dense_solve_info.restype = I
    lib.fb_mxu_max_n.argtypes = []
    lib.fb_mxu_max_n.restype = I
    lib.fb_mxu_probe.argtypes = [I, I, I, I, I, F] + [P] * 3 + [P]
    lib.fb_mxu_probe.restype = I
    lib.fb_mxu_probe_info.argtypes = [I, I, I, I, P]
    lib.fb_mxu_probe_info.restype = I
    bind_df_probe(lib)
    return lib


INFO_FIELDS = ("team", "teams_per_block", "registers", "local_bytes",
               "smem_bytes", "blocks_per_sm")
# fb_mxu_probe_info's record: the rows and lanes a thread holds and the
# grid's blocks follow.
MXU_INFO_FIELDS = INFO_FIELDS + ("rows", "lanes", "blocks")


def kernel_info(fn, *dims, fields=INFO_FIELDS) -> dict:
    """A kernel's launch shape at these dims, from its C info function
    (`lib.fb_mpc_solve_info`, `lib.fb_mpc_subproblem_info` or
    `lib.fb_riccati_info` at (N, nx, nu, nc, lowmem),
    `lib.fb_dense_solve_info` at (n, q, nl), `lib.fb_combine_info` at n;
    `lib.fb_mxu_probe_info` at
    (form, n, N1, B) with fields=MXU_INFO_FIELDS)."""
    info = (ctypes.c_int * len(fields))()
    check(fn(*dims, info), "kernel info")
    return dict(zip(fields, info))


def bind_df_probe(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declares fb_df_probe (also for a library built by build_variant)."""
    lib.fb_df_probe.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                                + [ctypes.c_void_p])
    lib.fb_df_probe.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Builds (once per source hash) and loads the kernel library."""
    with telemetry.span("fbstab.load_library"):
        path = library_path()
        if not path.exists():
            _compile(path)
        return _bind(ctypes.CDLL(str(path)))


def build_variant(source: str, defines: tuple = ()) -> Path:
    """Builds one source of csrc/ alone, with extra `-D` flags and the
    library's other flags, into its own shared library under BUILD_DIR
    (keyed by a hash like the library's); returns its path. For checks
    that compare a kernel compiled two ways."""
    src = SRC_DIR / source
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    for p in [src] + _sources()[1]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        flags = [f"-D{d}" for d in defines]
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *flags, "-shared",
                               "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} {flags} "
                               f"({proc.returncode}):\n{proc.stderr}"
                               f"{proc.stdout}")
        out.with_suffix(".log").write_text(proc.stderr + proc.stdout)
        os.replace(tmp, out)
    return out


def check(err: int, what: str) -> None:
    """Raises when a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


class KernelResourceError(RuntimeError):
    """A kernel launch whose device-memory scratch the card cannot give,
    raised before anything is allocated; nothing falls back. (Shared
    memory a launch can always have: the kernels work in place where a
    block cannot hold their stage blocks.)"""


@functools.lru_cache(maxsize=None)
def _memory_of(index: int) -> int:
    import torch
    return torch.cuda.get_device_properties(index).total_memory


def device_memory_bytes(device):
    """The memory of a CUDA `device` in bytes, cached: asking CUDA for the
    free memory (cudaMemGetInfo) at each launch cost K1 0.8-1.1 ms a launch
    at the headline on an H100 80GB HBM3 at 700 W (tools/ab_mpc.py, in
    turns); None off the card."""
    if device.type != "cuda":
        return None
    import torch
    index = device.index
    return _memory_of(torch.cuda.current_device() if index is None else index)


def check_scratch(what: str, B: int, ws_floats: int, device) -> None:
    """Raises KernelResourceError before a launch of `what` whose
    scratch, B instances of ws_floats float32 each, is more than the
    card's memory; a smaller one that does not fit beside what is already
    allocated raises torch's OutOfMemoryError when it is allocated."""
    memory = device_memory_bytes(device)
    need = 4 * B * ws_floats
    if memory is not None and need > memory:
        raise KernelResourceError(
            f"{what} needs {need} bytes of device-memory scratch for "
            f"{B} instances, beyond the {memory} bytes of {device}")
