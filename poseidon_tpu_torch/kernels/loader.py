"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface and loaded with ``ctypes``. No
PyTorch header is compiled, so a build takes seconds, and the sources
are compiled in parallel: one ``nvcc`` process per source, all started
together on the first call to ``library`` (or ``build_all``).

Libraries go to ``kernels/_build/`` (listed in ``.gitignore``), named by
a hash of their sources and flags, so an edited source rebuilds and a
stale library is never loaded. The sources in ``_STAMPED`` are built a
second time with ``-DPHASE_STAMPS`` as the library ``<name>_stamps``:
the same kernels writing ``clock64()`` phase stamps (``csrc/common.cuh``
``Stamps``), which only the wrappers' ``phase_stamps`` diagnostics load. Each build's wall time goes to
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
    "ssp_augment", "top_will", "seat_sort", "loop_graph",
)
_STAMPED = ("top_will", "seat_sort")
# the entry points that take the stamps buffer (before the stream) in the
# stamps build
_STAMPED_ENTRIES = ("top_will_list_launch", "seat_sort_launch")
_HEADERS = ("common.cuh", "csr_plan.cuh", "ssp_loop.cuh")
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


# callables that fold completed graph launches into the counts
# (kernels/loop_graph.py): a kernel captured into a graph launches when
# the graph runs, not when its wrapper is called
_settlers: list = []


def register_settle(fn) -> None:
    _settlers.append(fn)


def _settle() -> None:
    for fn in _settlers:
        fn()


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel: where it lives, what it replaces, and
    how many times it has been launched. ``launches`` is bumped only
    where the wrapper launches the CUDA kernel, never on the plain (CPU)
    path, and by the auction loop's graph for the runs of the kernels
    captured into it (``count`` holds what is settled; reading or
    setting ``launches`` settles the completed graph runs first)."""

    name: str
    source: str      # path in the repository
    replaces: str    # file:line of the reference's device program
    count: int = 0
    # the launches by the method the wrapper took, where it has several
    # (K13: "split", "onesweep", "compact"); settled with ``count``
    by: dict = dataclasses.field(default_factory=dict)

    @property
    def launches(self) -> int:
        _settle()
        return self.count

    @launches.setter
    def launches(self, n: int) -> None:
        _settle()
        self.count = n
        if n == 0:
            self.by.clear()

    def launched(self, method: str) -> None:
        """One launch by the wrapper, by ``method``."""
        self.launches += 1
        self.by[method] = self.by.get(method, 0) + 1

    @property
    def launches_by(self) -> dict[str, int]:
        _settle()
        return dict(self.by)


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


def _builds() -> dict[str, tuple[str, tuple[str, ...]]]:
    """Every library: its source and its nvcc flags."""
    out = {name: (name, NVCC_FLAGS) for name in _SOURCES}
    for name in _STAMPED:
        out[f"{name}_stamps"] = (name, (*NVCC_FLAGS, "-DPHASE_STAMPS"))
    return out


def _lib_path(name: str) -> pathlib.Path:
    source, flags = _builds()[name]
    h = hashlib.sha256()
    for part in (f"{source}.cu", *_HEADERS):
        h.update((_CSRC / part).read_bytes())
    h.update(" ".join(flags).encode())
    return _BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> BuildReport:
    """Compile every source that has no up-to-date library, all ``nvcc``
    processes at once, then load all libraries. Returns the wall time
    and the compiler's register/shared-memory report per source."""
    with _lock:
        t0 = time.perf_counter()
        _BUILD.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, (source, flags) in _builds().items():
            out = _lib_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen(
                [_nvcc(), *flags, "-o", str(tmp), str(_CSRC / f"{source}.cu")],
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
        for name in _builds():
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


def driver() -> ctypes.CDLL:
    """The CUDA driver (``libcuda``), opened once, for the driver calls
    no kernel library wraps: ``kernel_ab.py``'s print of a loop graph
    (``cuGraphDebugDotPrint``)."""
    with _lock:
        lib = _libs.get("cuda")
        if lib is None:
            lib = _libs["cuda"] = ctypes.CDLL("libcuda.so.1")
            lib.cuGraphDebugDotPrint.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint]
        return lib


def _declare(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    """Type every entry point: pointers and the stream as c_void_p (a
    bare Python int would be cut to 32 bits), sizes as c_int, 64-bit
    values as c_longlong. A stamps build's entries are its source's, the
    stamps buffer added before the stream where it takes one."""
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
            "bid_pass_launch": [P] * 6 + [I] * 8 + [P] * 5 + [P],
            "bid_pass_occupancy": occupancy,
        },
        "express_rows": {
            "express_rows_launch": [P, P],
        },
        "express_patch": {
            "express_patch_launch": [P] * 13 + [I] * 5 + [P],
        },
        "stream_commit": {
            "stream_commit_launch": [P, P],
            "stream_restore_launch": [P] * 4 + [I] * 5 + [P],
        },
        "perturb": {
            "perturb_launch": [P] * 11 + [I] * 12 + [P],
        },
        "gap_rows": {
            "gap_rows_launch": [P] * 6 + [I] * 6 + [P, P],
            "gap_rows_occupancy": [I] + occupancy,
        },
        "cs_sweep": {
            "cs_sweep_launch": [P] * 13 + [I] * 5 + [P],
        },
        "bf_relax": {
            "bf_relax_out_launch": [P] * 8 + [I] * 5 + [P],
            "bf_relax_in_launch": [P] * 8 + [I] * 3 + [P, P],
        },
        "ssp_augment": {
            "ssp_step_launch": [P, I, P],
        },
        "top_will": {
            "top_will_list_launch": [P] * 5 + [I] * 5 + [P, I] + [P] * 3,
            "top_will_list_clusters": [I, I, I, ctypes.POINTER(I)],
            "top_will_merge_launch": [P, I, I, I, P, I, P, P],
            "top_will_hist_launch": [P] * 5 + [I] * 5 + [P, P, P],
            "top_will_pick_launch": [P, I, I, I, P, I, P, P, P],
        },
        "seat_sort": {
            "seat_sort_setup": [ctypes.POINTER(I)],
            "seat_sort_launch": [P] * 8 + [I] * 18 + [P] * 3,
            "seat_compact_launch": [P] + [I] * 4 + [P] * 3,
        },
        "loop_graph": {
            "lg_create": [P],
            "lg_handle": [P, P],
            "lg_child": [P, P, P, P],
            "lg_ctl": [P, P, P, P],
            "lg_cond": [P, P, ctypes.c_ulonglong, I, P, P],
            "lg_copy": [P, P, P, P, L, P],
            "lg_instantiate": [P, P],
            "lg_launch": [P, P],
            "lg_destroy": [P, P],
            "loop_ctl_launch": [P, P],
        },
    }[_builds()[name][0]]
    for fn_name, argtypes in sigs.items():
        if name.endswith("_stamps") and fn_name in _STAMPED_ENTRIES:
            argtypes = [*argtypes[:-1], P, argtypes[-1]]
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
