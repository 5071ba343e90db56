"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface and loaded with ``ctypes``. No
PyTorch header is compiled, so a build takes seconds, and the sources
are compiled in parallel: one ``nvcc`` process per source, all started
together on the first call to ``library`` (or ``build_all``).

Libraries go to ``kernels/_build/`` (listed in ``.gitignore``), named by
a hash of their sources and flags, so an edited source rebuilds and a
stale library is never loaded. Each build's wall time goes to
``guards.report_compile``. Nothing here runs at import time: the
CPU tests import every module, and there is no ``nvcc`` on a host
without the CUDA toolkit. A build failure raises with the compiler's
output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

from poseidon_tpu_torch.guards import report_compile

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
_BUILD = pathlib.Path(__file__).resolve().parent / "_build"
_SOURCES = (
    "densify", "row_options", "bid_pass", "express_rows", "express_patch",
    "stream_commit", "perturb", "gap_rows", "cs_sweep", "bf_relax",
    "ssp_augment",
)
_HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-lineinfo",
    "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and
    how many times its wrapper has launched it. ``launches`` is bumped
    only where the wrapper launches the CUDA kernel, never on the plain
    (CPU) path."""

    name: str
    source: str      # path in the repository
    replaces: str    # file:line of the reference's device program
    launches: int = 0


@dataclasses.dataclass(frozen=True)
class BuildReport:
    seconds: float
    ptxas: dict[str, str]   # per source: nvcc's -Xptxas -v output


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "poseidon_tpu_torch are built from source on first use"
    )


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for part in (f"{name}.cu", *_HEADERS):
        h.update((_CSRC / part).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> BuildReport:
    """Compile every source that has no up-to-date library, all ``nvcc``
    processes at once, then load all libraries. Returns the wall time
    and the compiler's register/shared-memory report per source."""
    with _lock:
        t0 = time.perf_counter()
        _BUILD.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in _SOURCES:
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ), tmp, out)
        ptxas = {}
        failures = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            ptxas[name] = log
            if proc.returncode != 0:
                failures.append(f"--- {name}.cu (rc={proc.returncode})\n{log}")
            else:
                os.replace(tmp, out)
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        if procs:
            # one sample per build: the sources compile in parallel
            report_compile((time.perf_counter() - t0) * 1000)
        for name in _SOURCES:
            if name not in _libs:
                _libs[name] = _declare(name, ctypes.CDLL(str(_lib_path(name))))
        return BuildReport(seconds=time.perf_counter() - t0, ptxas=ptxas)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, building all on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = _libs[name]
    return lib


def _declare(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type every entry point: pointers and the stream as c_void_p (a
    bare Python int would be cut to 32 bits), sizes as c_int, 64-bit
    values as c_longlong."""
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    occupancy = [I, ctypes.POINTER(I)]
    sigs = {
        "densify": {
            "densify_launch": [P] * 9 + [I] * 8 + [P],
            "densify_occupancy": [I] + occupancy,
        },
        "row_options": {
            "row_options_launch": [P] * 5 + [I] * 7 + [P],
            "row_options_occupancy": occupancy,
        },
        "bid_pass": {
            "bid_pass_launch": [P] * 5 + [I] * 9 + [P] * 5 + [P],
            "bid_pass_occupancy": occupancy,
        },
        "express_rows": {
            "express_rows_launch": [P] * 10 + [I] * 4 + [P],
        },
        "express_patch": {
            "express_patch_launch": [P] * 9 + [I] * 3 + [P],
        },
        "stream_commit": {
            "stream_commit_launch": [P] * 26 + [I] * 7 + [P],
            "stream_restore_launch": [P] * 4 + [I] * 5 + [P],
        },
        "perturb": {
            "perturb_launch": [P] * 11 + [I] * 6 + [P],
        },
        "gap_rows": {
            "gap_rows_launch": [P] * 6 + [I] * 3 + [P, P],
        },
        "cs_sweep": {
            "cs_sweep_launch": [P] * 10 + [L] + [I] * 2 + [P],
        },
        "bf_relax": {
            "bf_relax_out_launch": [P] * 6 + [I] + [P],
            "bf_relax_in_launch": [P] * 8 + [I] * 2 + [P],
        },
        "ssp_augment": {
            "ssp_augment_launch": [P] * 7 + [I] * 5 + [P],
        },
    }[name]
    for fn_name, argtypes in sigs.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def occupancy(kernel: Kernel, fn, smem: int) -> int:
    """Blocks of a persistent kernel that fit on one SM with ``smem``
    bytes of dynamic shared memory, by its ``*_occupancy`` entry point
    (which also lifts the kernel's shared-memory cap). Call it with the
    kernel's device current; the plan caches keep the answer."""
    blocks = ctypes.c_int(0)
    err = fn(smem, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(
            f"occupancy query of {kernel.name} failed: cudaError {err}"
        )
    return blocks.value


def check_launch(kernel: Kernel, err: int) -> None:
    """Raise on a non-zero ``cudaGetLastError`` right after a launch: a
    refused launch never runs, and a later synchronise would not say so."""
    if err != 0:
        raise RuntimeError(
            f"CUDA kernel {kernel.name} failed to launch: cudaError {err}"
        )
