"""Build and load the hand-written CUDA kernels at first use.

Route: one ``nvcc`` per source in ``csrc/``, all started together, each
compiling to an object; one more links the objects into a shared library
with a plain C interface, which :mod:`ctypes` loads.  No PyTorch headers
are compiled, so a build takes seconds.  The library lands in
``_build/<hash>/`` next to this file (listed in ``.gitignore``), keyed by a
hash of the sources and the commands, so an edited kernel rebuilds and an
unchanged one loads.

There is no fallback: a missing ``nvcc``, a failed compile or a failed
load raises :class:`KernelBuildError`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
SOURCES = ("stats_k1.cu", "stats_k2.cu")
HEADERS = ("stats_common.cuh",)  # included by the sources
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"
# no --use_fast_math: the per-read mean must be the IEEE-rounded quotient
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
LINK_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-shared")

_lock = threading.Lock()
_lib = None


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


class K1Crit(ctypes.Structure):
    """Mirror of ``struct K1Crit`` in ``csrc/stats_common.cuh``."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "on", "min_len", "max_len", "min_q", "max_q", "oq_on", "max_oq",
        "qwin_on", "begin", "end", "left_len", "min_lq", "max_lq",
        "right_len", "min_rq", "max_rq", "max_n", "phred")]


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or
    :data:`NVCC_FALLBACK`."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), NVCC_FALLBACK):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise KernelBuildError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile the kernels if needed; returns the library path."""
    out_dir = os.path.join(BUILD_DIR, _digest())
    lib_path = os.path.join(out_dir, "libhpgq_kernels.so")
    if os.path.exists(lib_path):
        return lib_path
    nvcc = nvcc_path()
    os.makedirs(out_dir, exist_ok=True)
    work = tempfile.mkdtemp(dir=out_dir)
    objs = [os.path.join(work, src + ".o") for src in SOURCES]
    ptxas = ["-Xptxas", "-v"] if verbose else []
    try:
        with ThreadPoolExecutor(len(SOURCES)) as pool:  # one nvcc per source
            logs = list(pool.map(lambda src, obj: _nvcc(
                [nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", obj,
                 os.path.join(CSRC, src)]), SOURCES, objs))
        if verbose:
            print("".join(logs), end="")
        _nvcc([nvcc, *LINK_FLAGS, "-o", os.path.join(work, "lib.so"), *objs])
        # atomic: concurrent builders agree
        os.replace(os.path.join(work, "lib.so"), lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path


def _nvcc(cmd) -> str:
    """Run one nvcc command; returns its stderr (ptxas reports)."""
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise KernelBuildError("nvcc failed (%d):\n%s\n%s" % (
            res.returncode, " ".join(cmd), res.stderr))
    return res.stderr


def load(verbose: bool = False):
    """The loaded kernel library (built on first call), with argtypes set."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build(verbose)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise KernelBuildError("cannot load %s: %s" % (path, e)) from e
        p, i = ctypes.c_void_p, ctypes.c_int
        # inputs, sizes, criteria, then the 7 int64 outputs (scalars ...
        # bpn), then each entry's own outputs, then the stream
        lib.hpgq_k1_launch.argtypes = [p, p, p, p, i, i, i, i, K1Crit,
                                       *[p] * 7, p, p, p, p, p]
        lib.hpgq_k1_launch_2u.argtypes = [p, p, i, p, i, i, i, i, i, K1Crit,
                                          *[p] * 7, p, p, p, p, p]
        lib.hpgq_k2_launch.argtypes = [p, p, p, p, i, i, i, K1Crit,
                                       *[p] * 7, p, p, p, p]
        for fn in (lib.hpgq_k1_launch, lib.hpgq_k1_launch_2u,
                   lib.hpgq_k2_launch):
            fn.restype = i
        lib.hpgq_k1_tiles.argtypes = [i, i, i, i, i]
        lib.hpgq_k1_tiles.restype = i
        lib.hpgq_k2_scratch_slots.argtypes = [i]
        lib.hpgq_k2_scratch_slots.restype = ctypes.c_longlong
        lib.hpgq_k1_error_string.argtypes = [i]
        lib.hpgq_k1_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib
